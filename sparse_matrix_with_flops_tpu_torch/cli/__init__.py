"""Command-line programs of the port: nrmcl (R-MCL with its oracle)."""
