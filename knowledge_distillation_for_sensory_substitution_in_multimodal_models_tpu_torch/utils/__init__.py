"""Host utilities: synthetic batches (``synthetic``) and number words
(``numwords``), copies of the JAX package's modules of the same names."""
