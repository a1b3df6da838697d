"""The card benchmark of ``deepcalcium_torch``: see ``README.md``."""
