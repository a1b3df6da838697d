"""Where datasets and checkpoints live: the same JSON config file and
directories as ``deepcalcium_tpu.utils.config``, so that both packages share
them, read without importing the JAX package.

The root is ``$DEEPCALCIUM_TPU_DIR``, or ``~/.deep-calcium-tpu``; the file
``deep-calcium-tpu.json`` there names ``datasets_dir`` and
``checkpoints_dir``. Both are created on first use, not at import.
"""

import json
import os

__all__ = ["datasets_dir", "checkpoints_dir"]


def _base_dir() -> str:
    return (os.environ.get("DEEPCALCIUM_TPU_DIR")
            or os.path.join(os.path.expanduser("~"), ".deep-calcium-tpu"))


def _config() -> dict:
    bd = _base_dir()
    os.makedirs(bd, exist_ok=True)
    path = os.path.join(bd, "deep-calcium-tpu.json")
    if os.path.exists(path):
        try:
            with open(path) as fp:
                config = json.load(fp)
        except json.JSONDecodeError as e:
            raise RuntimeError(f"config file {path} is corrupt ({e}); delete "
                               f"it to regenerate defaults") from e
    else:
        config = {"datasets_dir": os.path.join(bd, "datasets"),
                  "checkpoints_dir": os.path.join(bd, "checkpoints")}
        tmp = path + ".tmp"  # tmp + rename: never a truncated file
        with open(tmp, "w") as fp:
            json.dump(config, fp)
        os.replace(tmp, path)
    os.makedirs(config["datasets_dir"], exist_ok=True)
    os.makedirs(config["checkpoints_dir"], exist_ok=True)
    return config


def datasets_dir() -> str:
    """The shared dataset root directory (created if missing)."""
    return _config()["datasets_dir"]


def checkpoints_dir() -> str:
    """The shared checkpoint root directory (created if missing)."""
    return _config()["checkpoints_dir"]
