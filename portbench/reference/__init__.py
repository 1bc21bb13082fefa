"""Plain PyTorch references, one module a model family; they import
nothing of the program."""
