"""The plain reference: the state machine's semantics written out again
in plain Python (``arithmetic.py``) and the check that holds a run's
answers to them (``check.py``).  Nothing here imports the program or
JAX."""

from benchmark.reference import arithmetic

MACHINES = {"arithmetic": arithmetic}
