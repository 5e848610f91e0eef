"""The benchmark's plain reference: the tracker step, its plant and the
track tables in plain PyTorch, independent of the program under test."""
