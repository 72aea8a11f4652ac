"""Plain references of what the cells drive: the input generators, C = A·B
and R-MCL, in NumPy and plain PyTorch.  Nothing here imports the port or
takes anything the port has made."""
