"""Work arithmetic of the benchmark: the card's published peaks, the least
time of a kernel launch from its operations and bytes (``kernels``), and
the operations a training step needs (``step``).  Computed from shapes
alone; nothing here reads the program."""
