"""Example workflows of the PyTorch port, one file for each script under
``examples/``: the same names, arguments and printed lines, on
``deepcalcium_torch``. Each has ``main(argv=None)``; those that run a model
take ``--device {cuda,cpu}`` and default to the card."""
