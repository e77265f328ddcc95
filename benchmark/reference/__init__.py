"""The plain reference the benchmark holds the program against: plain
PyTorch, importing nothing of the program and nothing of JAX."""
