"""Frozen copies of the port's numpy golden models and tables: the
benchmark's transmitter builds its frame pool with them, and its CPU tests
hold the reference against their receivers.  Nothing here imports the
program."""
