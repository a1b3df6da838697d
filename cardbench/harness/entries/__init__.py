"""The wrappers' entry points that a traffic file can drive, one module
each, found by the traffic file's ``"entry"``. Each module defines
``Entry(config, traffic, seed, device, seconds)`` with ``setup()``,
``window(seconds, spans)`` -> the end-to-end readings, ``counts``,
``release()`` and ``compare()`` -> the compared numbers."""

import importlib


def load(name):
    return importlib.import_module(f"cardbench.harness.entries.{name}").Entry
