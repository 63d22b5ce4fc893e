"""The benchmark's plain reference: KISS-ICP in PyTorch (`kiss.py`).

It imports nothing of the program under test."""
