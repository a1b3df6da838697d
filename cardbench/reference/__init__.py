"""The plain reference of the benchmark's cells: plain PyTorch and numpy,
written from the published models and the wrappers' documented semantics.
It imports nothing of the measured package and takes nothing it made:
weights come from the benchmark's own generator, and whatever the program
derives from its inputs (the fold, the summary, the mask summary, the
sampled windows) is worked out here again."""
