"""The plain reference that decides ``correct``: plain PyTorch only."""
