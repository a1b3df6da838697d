"""Import hygiene of the PyTorch port, and its refusal to run without a card.

``tests/conftest.py`` imports jax into every test process, so the checks
that the port never imports jax run in a fresh interpreter.
"""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(*args, timeout=180):
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_chip_smoke_never_import_jax():
    """Nor the JAX package: the port stands on its own. Nor h5py, PIL,
    requests or matplotlib at import: the card machine has none of
    them."""
    code = (
        "import sys\n"
        "import deepcalcium_torch.models.unet_2d_summary\n"
        "import deepcalcium_torch.metrics.neurofinder\n"
        "import deepcalcium_torch.ops.mask_summary\n"
        "import deepcalcium_torch.ops.losses\n"
        "import deepcalcium_torch.ops._build\n"
        "import deepcalcium_torch.train.callbacks\n"
        "import deepcalcium_torch.train.sampler\n"
        "import deepcalcium_torch.train.trainer\n"
        "import deepcalcium_torch.utils.profiling\n"
        "import deepcalcium_torch.utils.benchtools\n"
        "import deepcalcium_torch.utils.runtime\n"
        "import deepcalcium_torch.utils.visualization\n"
        "import deepcalcium_torch.utils.config\n"
        "import deepcalcium_torch.interop.keras_import\n"
        "import deepcalcium_torch.data.nf\n"
        "import deepcalcium_torch.data.custom\n"
        "import deepcalcium_torch.data._ingest\n"
        "import deepcalcium_torch.data.tiff_native\n"
        "import deepcalcium_torch.train.evaluate\n"
        "import deepcalcium_torch.ops.summary\n"
        "import deepcalcium_torch.models.unet1d\n"
        "import deepcalcium_torch.models.unet_1d_segmentation\n"
        "import deepcalcium_torch.models.glm_spikes\n"
        "import deepcalcium_torch.models.c2s_segmentation\n"
        "import deepcalcium_torch.models.cellpose_summary\n"
        "import deepcalcium_torch.ops.attention\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepcalcium_tpu'))\n"
        "assert not bad, bad\n"
        "lazy = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('h5py', 'PIL', 'requests', 'matplotlib'))\n"
        "assert not lazy, lazy\n"
        "print('clean')\n")
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


@pytest.mark.parametrize("module", [
    "deepcalcium_torch.cli",
    "deepcalcium_torch.models.movie_segmentation",
    "deepcalcium_torch.ops.mask_summary",
    "deepcalcium_torch.utils.model_downloads",
    "deepcalcium_torch.data.fixtures",
    "deepcalcium_torch.parallel.mesh",
    "deepcalcium_torch.parallel.distributed",
    "deepcalcium_torch.parallel.dryrun",
    "examples_torch.neurons.unet2ds_nf",
    "examples_torch.neurons.unet2ds_sj",
    "examples_torch.neurons.nf_videos",
    "examples_torch.neurons.unet2ds_hyperparam_search",
    "examples_torch.spikes.unet1d_spikes",
    "examples_torch.analysis.dataset_stats",
    "examples_torch.analysis.activation_maps",
    "examples_torch.analysis.spike_stats",
    "deepcalcium_torch.utils.benchtools",
    "examples_torch.analysis.evaluator_stage_bench",
    "examples_torch.analysis.unet_layer_bench",
    "examples_torch.analysis.unet1d_roofline",
    "examples_torch.analysis.train_step_profile",
    "examples_torch.analysis.train_mfu_sweep",
])
def test_module_imports_no_jax_and_no_h5py(module):
    """Each module alone, in a fresh interpreter: nothing of JAX or of the
    JAX package, and none of h5py, PIL, requests or matplotlib (the command
    line and the example scripts must start on a machine without them). No
    import forms a process group."""
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepcalcium_tpu', 'h5py', 'PIL', "
        "'requests', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_package_import_is_light():
    """``import deepcalcium_torch`` loads no submodule and not torch."""
    code = ("import sys, deepcalcium_torch\n"
            "print(deepcalcium_torch.__version__, 'torch' in sys.modules)\n")
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0.1.0", "False"]


def test_chip_smoke_fails_without_a_card():
    """No fallback: on a machine with no CUDA card the smoke run exits
    non-zero and prints no ok line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    proc = _python("chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
