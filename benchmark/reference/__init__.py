"""Plain float32 PyTorch references: no code of the program under test."""
