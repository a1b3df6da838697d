"""Where datasets and checkpoints live: the same JSON config file and
directories as ``deepcalcium_tpu.utils.config``, so that both packages share
them, read without importing the JAX package.

The root is ``$DEEPCALCIUM_TPU_DIR``, or ``~/.deep-calcium-tpu``; the file
``deep-calcium-tpu.json`` there names ``datasets_dir`` and
``checkpoints_dir``. Both are created on first use, not at import.
"""

import json
import os

__all__ = ["base_dir", "config_path", "get_config", "datasets_dir",
           "checkpoints_dir"]


def base_dir() -> str:
    """Root directory for config, datasets and checkpoints."""
    return (os.environ.get("DEEPCALCIUM_TPU_DIR")
            or os.path.join(os.path.expanduser("~"), ".deep-calcium-tpu"))


def config_path() -> str:
    return os.path.join(base_dir(), "deep-calcium-tpu.json")


def get_config() -> dict:
    """The config's contents; the file and both directories are created
    when missing."""
    bd = base_dir()
    os.makedirs(bd, exist_ok=True)
    path = config_path()
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
    return get_config()["datasets_dir"]


def checkpoints_dir() -> str:
    """The shared checkpoint root directory (created if missing)."""
    return get_config()["checkpoints_dir"]
