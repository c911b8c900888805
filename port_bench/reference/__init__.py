"""Plain PyTorch references of the benchmark's model families; they import nothing of the program."""
