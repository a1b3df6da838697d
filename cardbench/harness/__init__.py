"""The benchmark's harness: set-up of a cell, its measured window, the
trace reduction, the yardstick and the comparison with the reference."""
