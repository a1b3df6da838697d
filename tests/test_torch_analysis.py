"""The port's measuring tools (``deepcalcium_torch/utils/benchtools.py`` and
the five scripts of ``examples_torch/analysis/`` that time the main path)
against the JAX package's, on the CPU.

Tolerances, each stated again where it is used: the censuses, FLOP and
byte counts and the train-step batches are equal; a parity block against
the JAX block in bf16 within 1e-2 of the block's largest output (a few bf16
ulps: the two packages' convs round their sums in other places); a folded
block against its parity block in float32 within 2e-6 of the largest
output (the census's standard-normal kernels give outputs up to about 70,
where a float32 ulp is 8e-6; measured at most 6e-7); the chained stages
equal the evaluator bit for bit.
"""

import numpy as np
import pytest
import torch

from deepcalcium_torch.train.checkpoints import load_checkpoint
from deepcalcium_torch.utils import benchtools as bt
from examples_torch.analysis import evaluator_stage_bench as tstages
from examples_torch.analysis import train_mfu_sweep as tsweep
from examples_torch.analysis import train_step_profile as tprofile
from examples_torch.analysis import unet1d_roofline as troof
from examples_torch.analysis import unet_layer_bench as tlayers

torch.set_num_threads(1)

SCRIPTS = {
    "evaluator_stage_bench": (tstages, ["--frames", "5", "--size", "48",
                                        "--nfb", "4", "--iters", "1",
                                        "--rounds", "2"]),
    "unet_layer_bench": (tlayers, ["--batch", "1", "--size", "32", "--nfb",
                                   "4", "--frames", "5", "--iters", "1"]),
    "train_step_profile": (tprofile, ["--batch", "2", "--win", "32", "--k",
                                      "2", "--nfb", "4", "--top", "5"]),
    "train_mfu_sweep": (tsweep, ["--k", "2", "--win", "32", "--batches", "2",
                                 "--drp0-batch", "2", "--nfb", "4",
                                 "--iters", "1"]),
}


@pytest.fixture(scope="module")
def jax_layers():
    from examples.analysis import unet_layer_bench

    return unet_layer_bench.block_fns()


def test_layer_census_matches_jax(jax_layers):
    rows = tlayers.census()
    assert len(rows) == len(jax_layers) == 21
    for (name, _, xshape, flops, nbytes, cout), row in zip(jax_layers, rows):
        assert row["name"] == name
        assert (row["flops"], row["bytes"], row["cout"]) == (flops, nbytes,
                                                              cout)
        b, c, h, w = row["x_shape"]
        assert (b, h, w, c) == xshape


@pytest.fixture(scope="module")
def port_parity_blocks():
    """The port's parity blocks at nfb=32 (the JAX census's kernels), in a
    forward of one 32x32 image."""
    return tlayers.block_fns(tlayers.census(1, 32, 32), "cpu")


@pytest.mark.parametrize("i", range(21))
def test_parity_block_matches_jax(jax_layers, port_parity_blocks, i):
    """The same numpy input through the JAX block and the port's, both in
    bf16: within 1e-2 of the largest output. The kernels are the two
    scripts' own draws from ``default_rng(0)``, so this holds the draws
    too."""
    import jax.numpy as jnp

    name, jfn = jax_layers[i][:2]
    row, fn = port_parity_blocks[i]
    b, c, h, w = row["x_shape"]
    x = np.random.default_rng(i).standard_normal((b, h, w, c)).astype(
        np.float32)
    want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = fn(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape, name
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), name


@pytest.fixture(scope="module")
def fold_diffs():
    return tlayers.fold_diffs(tlayers.census(2, 32, 4), "cpu", dtype=None)


@pytest.mark.parametrize("i", range(21))
def test_folded_block_matches_parity_block(fold_diffs, i):
    """float32: within 2e-6 of the block's largest output."""
    name = tlayers.census(2, 32, 4)[i]["name"]
    diff, ymax = fold_diffs[name]
    assert ymax > 1.0
    assert diff <= 2e-6 * ymax, (name, diff, ymax)


def test_stages_chain_to_the_movie_evaluator():
    """The six stages, chained from a 5x48x48 movie with the golden tiny
    net, give ``make_movie_evaluator``'s mask and prob bit for bit."""
    import os

    from deepcalcium_torch.models.unet2d import from_jax_params
    from deepcalcium_torch.train.evaluate import make_movie_evaluator

    gold = os.path.join(os.path.dirname(__file__), "golden", "unet2d_tiny.ckpt")
    params, state, _ = load_checkpoint(gold)
    model = from_jax_params(params, state).eval()
    movie = torch.from_numpy(np.random.default_rng(5).integers(
        0, 1500, (5, 48, 48)).astype(np.int16))
    stages = tstages.stages(model, movie.shape)
    assert [n for n, _ in stages] == ["summary", "z-norm", "tta_expand",
                                      "forward bf16 (folded)", "tta_collapse",
                                      "threshold"]
    outs = tstages.chain(stages, movie)
    mask, prob, _ = make_movie_evaluator(model, movie.shape,
                                         window=(48, 48))(movie)
    assert torch.equal(outs[-1], mask) and torch.equal(outs[-2], prob)
    assert 0 < int(mask.sum()) < mask.numel()


def test_unet1d_census_and_flops_match_jax():
    """The census is the JAX one; its FLOPs sum to batch x the forward that
    both packages' ``forward_flops`` count (the train step is 3x that)."""
    from deepcalcium_torch.models import unet1d as tunet1d
    from deepcalcium_tpu.models import unet1d as junet1d
    from examples.analysis import unet1d_roofline as jroof

    rows = troof.census(20, 4096, 32)
    assert rows == jroof.census(20, 4096, 32)
    flops = sum(2 * 20 * t * k * ci * co for _, t, ci, co, k in rows)
    assert flops == 20 * tunet1d.forward_flops(4096, 32)
    assert flops == 20 * junet1d.forward_flops(4096, 32)
    out = troof.main(["--step-ms", "8.0"])
    assert [r["layer"] for r in out["rows"]] == [r[0] for r in rows]
    assert out["useful_flops"] == 3 * flops
    floor = sum(3 * max(r["flops"] / bt.BF16_FLOPS_PER_S,
                        r["bytes"] / bt.HBM_BYTES_PER_S) * 1e3
                for r in out["rows"])
    assert out["floor_ms"] == pytest.approx(floor, rel=1e-12)
    assert out["step_ms"] == 8.0


@pytest.mark.parametrize("net", ["unet2d", "unet1d"])
def test_train_step_batches_match_jax(net, monkeypatch):
    """The K batches bit for bit the JAX setup's, at nfb=4. The JAX nets'
    ``init`` (about 20 s of op-by-op compiles on the CPU) is replaced by a
    one-leaf tree: the batches do not depend on the weights."""
    import functools

    import jax.numpy as jnp

    from deepcalcium_tpu.models import unet1d as junet1d
    from deepcalcium_tpu.models import unet2d as junet2d
    from deepcalcium_tpu.utils import benchtools as jbt

    def init(key, nfb):
        return {"w": jnp.zeros((nfb,))}, {}

    monkeypatch.setattr(junet2d, "init", init)
    monkeypatch.setattr(junet1d, "init", init)
    if net == "unet2d":
        _, xs, ys = bt.train_step_setup(3, 32, 2, 4, 2e-3,
                                         "binary_crossentropy", None,
                                         torch.float32, "cpu")
        ref = jbt._train_step_setup(functools.partial(junet2d.apply), 3, 32,
                                    2, 4, 2e-3, "binary_crossentropy")
    else:
        _, xs, ys = bt.train1d_step_setup(3, 64, 2, 4, 2e-3, 4, None,
                                           torch.float32, "cpu")
        ref = jbt._train1d_step_setup(3, 64, 2, 4, 2e-3, 4)
    np.testing.assert_array_equal(xs, np.asarray(ref[4]))
    np.testing.assert_array_equal(ys, np.asarray(ref[5]))
    assert 0 < ys.sum() < ys.size


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("net", ["unet2d", "unet1d"])
def test_step_timers_run_on_the_cpu(net, k):
    if net == "unet2d":
        r = bt.train_step_time(2, 32, k=k, nfb=4, device="cpu", iters=1)
    else:
        r = bt.train1d_step_time(2, 64, k=k, nfb=4, device="cpu", iters=1)
    assert np.isfinite(r["step_ms"]) and r["step_ms"] > 0
    # No device number from a CPU run.
    assert r["device_ms"] is r["kernels"] is r["idle"] is None


@pytest.mark.parametrize("name, bucket", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_"
     "cudnn", "conv"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize64x128x64_warpgroupsize1x1x1", "conv"),
    ("void cudnn::cnn::wgrad_alg0_engine<float, 128, 6, 7, 3, 3, 5, false, "
     "512>(int, int, int, float const*, int, float*, float const*, "
     "kernel_grad_params, unsigned long long, int, float, int, int, int, "
     "int)", "conv"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
     "64x64_64x4_nn_align8>(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
     "64x64_64x4_nn_align8::Params)", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>"
     "(cudnn::engines_precompiled::nchw2nhwc_params_t<float>, "
     "__nv_bfloat16 const*, __nv_bfloat16*)", "copy-reshape"),
    ("void cudnn::ops::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float, "
     "true, false, (cudnnKernelDataType_t)0>(cudnn::ops::nhwc2nchw_params_t"
     "<float>, __nv_bfloat16 const*, __nv_bfloat16*)", "copy-reshape"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_aligned16_"
     "contig<at::native::(anonymous namespace)::OpaqueType<2u>, unsigned "
     "int, 4, 64, 64>(...)", "copy-reshape"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase"
     "&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() const"
     "::{lambda(c10::BFloat16)#1}> >(int, ...)", "copy-reshape"),
    ("Memcpy DtoD (Device -> Device)", "copy-reshape"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::WelfordOps<float, float, int, thrust::pair<float, float> >"
     ", unsigned int, float, 2> >(at::native::ReduceOp<float, at::native::"
     "WelfordOps<float, float, int, thrust::pair<float, float> >, unsigned "
     "int, float, 2>)", "bn"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::"
     "BFloat16, at::native::func_wrapper_t<float, at::native::sum_functor<"
     "c10::BFloat16, float, float>::operator()(at::TensorIterator&)::"
     "{lambda(float, float)#1}>, unsigned int, c10::BFloat16, 4> >(...)",
     "bn"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nchw<c10::"
     "BFloat16, float>(int, c10::BFloat16 const*, long, long, long, int, int,"
     " int, int, int, int, int, int, int, int, c10::BFloat16*, long*)",
     "pool"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nchw<c10::"
     "BFloat16, float>(c10::BFloat16 const*, long const*, int, long, long, "
     "long, int, int, int, int, int, int, int, int, int, int, c10::"
     "BFloat16*)", "pool"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid_"
     "stride_kernel<float, 4, at::native::templates::cuda::uniform_and_"
     "transform<float, float, at::CUDAGeneratorImpl*, ...>(...)",
     "dropout-rng"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDA"
     "Functor_add<c10::BFloat16>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul>)", "other"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
     "native::(anonymous namespace)::TensorListMetadata<4>, at::native::"
     "(anonymous namespace)::FusedAdamMathFunctor<float, 4, (at::native::"
     "ADAM_MODE)0, false>, ...>(...)", "other"),
    ("aten::convolution_backward", "conv"),
    ("aten::var_mean", "bn"),
    ("aten::max_pool2d_with_indices", "pool"),
    ("aten::uniform_", "dropout-rng"),
    ("aten::copy_", "copy-reshape"),
    ("aten::add_", "other"),
])
def test_bucket_of(name, bucket):
    assert tprofile.bucket_of(name) == bucket


@pytest.mark.parametrize("name, prefix", [
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
     "4, 4> >(...)", "at::native::reduce_kernel"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nchw<c10::"
     "BFloat16, float>(...)", "at::native::max_pool_forward_nchw"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_prefix_of(name, prefix):
    assert tprofile.prefix_of(name) == prefix


def test_interleaved_ms_takes_its_readings_round_robin():
    log = []
    fns = {name: (lambda name=name: log.append(name)) for name in "abc"}
    out = bt.interleaved_ms(fns, iters=2, rounds=3, device="cpu")
    assert log == list("abc") + (list("aabbcc") * 3)
    assert list(out) == list("abc")
    assert all(len(v) == 3 and all(ms >= 0 for ms in v) for v in out.values())


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_main_runs_on_the_cpu(script):
    mod, argv = SCRIPTS[script]
    out = mod.main(argv + ["--device", "cpu"])
    assert out["card"] == bt.card("cpu")
    assert out["rows"]
    for row in out["rows"]:
        ms = row.get("ms", row.get("step_ms", row.get("ms_per_step")))
        assert np.isfinite(ms) and ms >= 0
    if script == "evaluator_stage_bench":
        assert [r["stage"] for r in out["rows"]][-1] == "FULL evaluator"
        assert torch.equal(out["chained"][0], out["full"][0])
    if script == "unet_layer_bench":
        assert len(out["rows"]) == 23 and out["summary"] is not None
    if script == "train_mfu_sweep":
        assert [r["row"] for r in out["rows"]] == ["batch 2 win 32",
                                                   "drp=0 batch 2"]


def test_profile_rows_add_up_on_the_cpu():
    out = tprofile.main(SCRIPTS["train_step_profile"][1]
                        + ["--net", "unet1d", "--win", "64", "--device", "cpu"])
    buckets = [r for r in out["rows"] if r["what"] == "bucket"]
    assert {r["name"] for r in buckets} <= {b for b, _ in tprofile.BUCKETS} | {
        "other"}
    assert sum(r["pct_of_device"] for r in buckets) == pytest.approx(100.0)
    assert sum(r["ms_per_step"] for r in buckets) == pytest.approx(
        out["device_ms"])


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_refuses_cuda_without_a_card(script, monkeypatch):
    """No fallback: asked for the card where there is none, the script
    raises before it builds a net or a movie."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    mod, argv = SCRIPTS[script]
    monkeypatch.setattr(torch, "Generator", None)  # any work would fail
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
