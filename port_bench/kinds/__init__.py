"""One file per kind of model the configurations name (``"model"``): how
the harness builds it through the port's public constructor, what it
reads back from its state, and the numbers that decide ``correct``."""
