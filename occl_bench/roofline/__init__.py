"""Operation counts from shapes, and the card's published peaks.

Nothing here imports the program: every count is worked out from the sizes
a configuration file gives.
"""
