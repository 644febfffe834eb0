"""The plain reference the judge holds the program to (plain PyTorch;
nothing of the program)."""
