"""The plain reference the benchmark holds the program to: plain PyTorch and NumPy, no code of the program."""
