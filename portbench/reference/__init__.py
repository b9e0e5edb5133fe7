"""Plain PyTorch reference of what the benchmark's cells run. It imports
nothing of the program and takes no tensor the program has made."""
