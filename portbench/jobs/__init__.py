"""The drivers of the traffic mixes, one module a kind of job: each
``Job(cfg, traffic, seed, device)`` makes its inputs from the seed,
warms up (``warm``), runs item ``i`` of the window (``run(i)``, False
for a failed item), drops the program's state (``release``) and
compares what the window produced with the plain reference
(``check``: ``{number: value}``; ``compared``: results compared)."""
