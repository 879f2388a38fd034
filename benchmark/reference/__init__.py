"""Plain PyTorch references of what the cells run. They import nothing of
the program: every weight, table and grid they need is worked out again
from the inputs that the benchmark makes."""
