"""The benchmark's plain reference: plain PyTorch and numpy, nothing of the system
under test."""
