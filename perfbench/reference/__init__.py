"""The plain reference the benchmark holds the program to: its modules,
mLSTM, training step, sweep and precisions. It imports nothing of the
program."""
