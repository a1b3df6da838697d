"""Tests of the port that need a CUDA card (marker ``cuda``).

They skip where no card is present. This file imports neither jax nor the
JAX package, so that it also runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from deepcalcium_torch.models.unet2d import UNet2DS
from deepcalcium_torch.ops import summary
from deepcalcium_torch.train.evaluate import make_movie_evaluator

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype,lo,hi", [
    ((37, 24, 40), torch.int16, -100, 3000),
    ((31, 19, 137), torch.int16, -100, 3000),   # prime T, ragged H and W
    ((7, 8, 130), torch.int16, -5000, -10),     # all negative
    ((1, 40, 44), torch.int16, 0, 2000),        # T = 1
    ((13, 509, 511), torch.uint16, 0, 65536),
    ((10, 8, 130), torch.float32, -3000, 3000),
])
def test_k1_matches_plain_on_card(cuda_device, shape, dtype, lo, hi):
    """K1 against its plain version on the same card: bitwise for the max
    and for integer means (both sums are exact); rtol=1e-6 for float32
    means (float64 sums in another order)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    movie = torch.randint(lo, hi, shape, generator=g, device=cuda_device,
                          dtype=torch.int32).to(dtype)
    if dtype == torch.float32:
        movie += torch.rand(shape, generator=g, device=cuda_device)
    launches = summary.movie_summary_cuda.launches
    mean, mx = summary.movie_summary_cuda(movie)
    assert summary.movie_summary_cuda.launches == launches + 1
    pmean, pmx = summary.movie_summary(movie)
    assert torch.equal(mx, pmx.to(torch.float32))
    if dtype == torch.float32:
        torch.testing.assert_close(mean, pmean, rtol=1e-6, atol=0)
    else:
        assert torch.equal(mean, pmean)


def test_k1_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError):
        summary.movie_summary_cuda(torch.zeros((2, 4, 4), device=cuda_device,
                                               dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        summary.movie_summary_cuda(torch.zeros((2, 4, 8), device=cuda_device,
                                               dtype=torch.int16)[..., ::2])


@pytest.mark.parametrize("dtype,shape,chunk,misaligned", [
    (torch.int16, (3000, 512, 512), 256, False),    # ragged 184-frame tail
    (torch.uint16, (3000, 512, 512), 256, False),
    (torch.float32, (3000, 512, 512), 256, False),
    (torch.int16, (301, 64, 72), 64, True),         # misaligned base
    (torch.int16, (77, 19, 137), 16, False),        # H*W tail
    (torch.uint16, (45, 9, 131), 8, True),
    (torch.float32, (33, 13, 29), 7, False),
])
def test_k1_fold_matches_plain_fold_on_card(cuda_device, dtype, shape, chunk,
                                            misaligned):
    """K1's fold through a staging buffer poisoned past n_valid, against the
    plain fold and one K1 call (``chip_smoke.check_fold``): integer totals
    equal and means bitwise K1's; float32 means within 1 ulp; maxima
    equal."""
    from chip_smoke import check_fold

    g = torch.Generator(device=cuda_device).manual_seed(1)
    if dtype == torch.float32:
        movie = torch.rand(shape, generator=g, device=cuda_device) * 4000 - 2000
    else:
        lo, hi = (-2000, 30000) if dtype == torch.int16 else (0, 65536)
        movie = torch.randint(lo, hi, shape, generator=g, device=cuda_device,
                              dtype=torch.int32).to(dtype)
    launches = summary.movie_fold_cuda.launches
    check_fold(cuda_device, movie, chunk, misaligned)
    assert summary.movie_fold_cuda.launches == launches + -(-shape[0] // chunk)


def test_k1_fold_rejects_what_it_does_not_take(cuda_device):
    chunk = torch.zeros((4, 8, 8), dtype=torch.int16, device=cuda_device)
    total, mx = summary.fold_accumulators((8, 8), torch.int16, cuda_device)
    for n in (0, -1, 5):
        with pytest.raises(ValueError, match="n_valid"):
            summary.movie_fold_cuda(chunk, n, total, mx)
    with pytest.raises(TypeError, match="totals"):
        summary.movie_fold_cuda(chunk, 2, total.double(), mx)
    with pytest.raises(ValueError, match="contiguous"):
        summary.movie_fold_cuda(torch.zeros((4, 8, 16), dtype=torch.int16,
                                            device=cuda_device)[..., ::2], 2,
                                total, mx)
    with pytest.raises(ValueError, match="CUDA"):
        summary.movie_fold_cuda(chunk.cpu(), 2, total, mx)


def test_streaming_summary_on_card_matches_k1(cuda_device):
    """Host chunks staged through the pinned buffer, with a ragged tail and
    a chunk split in two: mean and max bitwise K1's."""
    rng = np.random.default_rng(3)
    movie = rng.integers(-500, 4000, (103, 96, 80)).astype(np.int16)
    ss = summary.StreamingSummary((96, 80), dtype=np.int16, device="cuda")
    ss.update(movie[:10])
    ss.update(movie[10:35])   # split into slabs of 10
    ss.update(movie[35:])
    mean, mx = ss.result()
    k1_mean, k1_max = summary.movie_summary_cuda(
        torch.from_numpy(movie).to(cuda_device))
    np.testing.assert_array_equal(mean, k1_mean.cpu().numpy())
    np.testing.assert_array_equal(mx, k1_max.cpu().numpy().astype(np.int16))


@pytest.mark.parametrize("dtype,maxulp", [(np.int16, 0), (np.uint16, 0),
                                          (np.float32, 1)])
def test_sharded_summary_on_an_nccl_group_of_one_matches_k1(cuda_device, dtype,
                                                            maxulp):
    """The sharded summary over NCCL, from a movie on the card and from the
    same movie on the host: K1's fold per chunk, then both all-reduces.
    Integer movies give one K1 call's bits; float32 ones are within 1 ulp
    (float64 partial sums, grouped by chunk)."""
    from deepcalcium_torch.parallel import distributed

    rng = np.random.default_rng(11)
    host = (rng.random((37, 96, 80)) * 4000).astype(dtype)
    movie = torch.from_numpy(host).to(cuda_device)
    k1_mean, k1_max = summary.movie_summary_cuda(movie)
    distributed.initialize(f"127.0.0.1:{distributed._free_port()}", 1, 0)
    try:
        mesh = distributed.pod_mesh()
        assert mesh.device.type == "cuda" and mesh.size == 1
        for source in (movie, host):
            before = summary.movie_fold_cuda.launches
            mean, mx = summary.movie_summary_sharded(source, mesh, chunk=8)
            assert summary.movie_fold_cuda.launches - before == 5
            assert mean.device == mx.device == movie.device
            np.testing.assert_array_max_ulp(mean.cpu().numpy(),
                                            k1_mean.cpu().numpy(),
                                            maxulp=max(maxulp, 1))
            if not maxulp:
                np.testing.assert_array_equal(mean.cpu().numpy(),
                                              k1_mean.cpu().numpy())
            np.testing.assert_array_equal(mx.cpu().numpy(),
                                          k1_max.cpu().numpy())
    finally:
        distributed.shutdown()


def test_movie_evaluator_on_card_matches_cpu(cuda_device):
    """The whole slice at a small size: the card (K1, float32 convs with
    TF32 off) against the CPU (plain summary), rtol=1e-4, atol=1e-5 on prob
    for sums in another order."""
    rng = np.random.default_rng(7)
    movie = torch.from_numpy(rng.integers(0, 1500, (20, 48, 48)).astype(np.int16))
    model = UNet2DS(nfb=4, generator=torch.Generator().manual_seed(3)).eval()
    cpu = make_movie_evaluator(model.fold(), movie.shape, window=(48, 48))(movie)
    torch.backends.cudnn.allow_tf32 = False
    try:
        gpu_model = model.to(cuda_device).fold()
        gpu = make_movie_evaluator(gpu_model, movie.shape, window=(48, 48))(
            movie.to(cuda_device))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    mask, prob, mean = (a.cpu() for a in gpu)
    assert torch.equal(mean, cpu[2])
    torch.testing.assert_close(prob, cpu[1], rtol=1e-4, atol=1e-5)
    near = (cpu[1] - 0.5).abs() < 1e-4
    assert torch.equal(mask[~near], cpu[0][~near])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool2_tie_routing_on_card(cuda_device, dtype):
    """The 2x2 max-pool gradient on the card goes to the first maximum of
    each window in row-major order, as the JAX package's dense vjp routes
    it: all-equal windows, a (1, 2; 2, 0) window and ReLU zeros."""
    from chip_smoke import first_max_grad
    from deepcalcium_torch.models.blocks import maxpool2

    rng = np.random.default_rng(5)
    z = np.maximum(rng.standard_normal((2, 3, 8, 8)), 0).astype(np.float32)
    z[0, 0, 0:2, 0:2] = [[1.0, 2.0], [2.0, 0.0]]
    z[1, 2, 4:8, 2:6] = 3.0
    ct = torch.from_numpy(rng.standard_normal((2, 3, 4, 4)).astype(np.float32))
    zt = torch.from_numpy(z).to(cuda_device, dtype).requires_grad_()
    maxpool2(zt).backward(ct.to(cuda_device, dtype))
    want = first_max_grad(z, ct.to(dtype).float().numpy())
    np.testing.assert_array_equal(zt.grad.float().cpu().numpy(), want)


def test_bf16_train_step_lowers_the_loss_on_card(cuda_device):
    """5 bf16 train steps (nfb=4, dropout on) on one fixed batch: the loss
    stays finite and falls."""
    from deepcalcium_torch.ops.losses import binary_crossentropy
    from deepcalcium_torch.train import trainer

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32)).astype(np.float32))
    y = torch.zeros(4, 32, 32)
    y[:, 8:24, 8:24] = 1.0
    model = UNet2DS(nfb=4, compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(1)).to(cuda_device)
    step = trainer.make_train_step(model, binary_crossentropy,
                                   trainer.make_optimizer(model, 2e-3))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, y = x.to(cuda_device), y.to(cuda_device)
    losses = [step(x, y, gen)["loss"].item() for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_multi_step_graph_matches_eager_steps_on_card(cuda_device):
    """``make_multi_step`` (one CUDA graph of 3 steps) for two calls against
    6 eager steps with the same capturable optimizer and an average, bf16
    at nfb=4 with dropout from a device generator in the same state, cuDNN
    deterministic: weights, buffers, Adam's state, the average, the metrics
    and the generator equal bit for bit. Then an lr of 0 reaches the graph:
    a call moves no weight."""
    import copy

    from deepcalcium_torch.ops.losses import binary_crossentropy
    from deepcalcium_torch.train import trainer

    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((3, 4, 32, 32)).astype(
        np.float32)).to(cuda_device)
    ys = (torch.rand(xs.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device) < 0.2).float()
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for graphed in (True, False):
            model = UNet2DS(nfb=4, compute_dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(1)
                            ).to(cuda_device)
            ema = copy.deepcopy(model)
            opt = trainer.make_optimizer(model, 2e-3)
            gen = torch.Generator(device=cuda_device).manual_seed(2)
            if graphed:
                step = trainer.make_multi_step(model, binary_crossentropy, opt,
                                               3, ema=ema, ema_decay=0.9)
                mets = [step(xs, ys, gen) for _ in range(2)]
            else:
                trainer.make_capturable_(opt)
                step = trainer.make_train_step(model, binary_crossentropy, opt)
                mets = []
                for _ in range(2):
                    for k in range(3):
                        mets.append(step(xs[k], ys[k], gen))
                        trainer.ema_update(ema.parameters(),
                                           model.parameters(), 0.9)
            state = [t.detach().clone() for t in
                     list(model.parameters()) + list(model.buffers())
                     + list(ema.parameters())]
            for p in model.parameters():
                state += [v.clone() for v in opt.state[p].values()]
            runs.append((state, trainer.metric_rows(mets, sorted(mets[0])),
                         gen.get_state()))
            if graphed:
                trainer.set_lr(opt, 0.0)
                before = [p.detach().clone() for p in model.parameters()]
                step(xs, ys, gen)
                assert all(torch.equal(a, p) for a, p in
                           zip(before, model.parameters()))
    finally:
        torch.backends.cudnn.deterministic = False
    (sa, ma, ga), (sb, mb, gb) = runs
    assert ma.shape == (6, 8) and torch.isfinite(ma).all()
    assert torch.equal(ma, mb) and torch.equal(ga, gb)
    assert len(sa) == len(sb) and all(torch.equal(a, b) for a, b in zip(sa, sb))


# --- the spike path ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_1d_pool_tie_routing_on_card(cuda_device, dtype):
    """The window-2 pool and the margin head (windows 1-8) on the card send
    each tied gradient to its window's first maximum, as the JAX package's
    vjps route it (``chip_smoke.check_1d_tie_routing``, integer
    cotangents so that only the routing is compared)."""
    from chip_smoke import check_1d_tie_routing

    check_1d_tie_routing(cuda_device, dtype)


def test_unet1d_on_card_matches_cpu(cuda_device):
    """Eval forward of a random nfb=4 UNet1D at margin 3 (an even window):
    the card at float32 with TF32 off against the CPU, rtol 1e-4 atol 1e-6
    (sums in another order)."""
    from deepcalcium_torch.models.unet1d import UNet1D

    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 272)).astype(np.float32))
    model = UNet1D(nfb=4, margin=3, generator=torch.Generator().manual_seed(5)).eval()
    with torch.no_grad():
        cpu = model(x)
        torch.backends.cudnn.allow_tf32 = False
        try:
            gpu = model.to(cuda_device)(x.to(cuda_device)).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = True
    torch.testing.assert_close(gpu, cpu, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("net", ["unet2d", "unet1d"])
def test_direct_inference_build_on_card_is_bitwise(cuda_device, net, fold):
    """The direct build at the published width (nfb 32, bf16) through the
    page-locked staging buffer, twice, against the drawn net loaded, moved
    to the card and folded: every parameter and buffer, and a forward,
    bitwise."""
    from deepcalcium_torch.models import unet1d, unet2d

    mod = unet2d if net == "unet2d" else unet1d
    cls = unet2d.UNet2DS if net == "unet2d" else unet1d.UNet1D
    params, state = mod.to_jax_params(cls(32))
    rng = np.random.default_rng(3)
    for name in state:
        c = state[name]["mean"].shape
        state[name] = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        params[name] = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                        "beta": rng.normal(0, 0.2, c).astype(np.float32)}
    x = torch.from_numpy(rng.standard_normal(
        (2, 256, 256) if net == "unet2d" else (4, 4096)).astype(
            np.float32)).to(cuda_device)
    with torch.no_grad():
        old = mod.load_jax_params_(cls(32, compute_dtype=torch.bfloat16),
                                   params, state).to(cuda_device).eval()
        old = old.fold() if fold else old
        want = old(x)
        for _ in range(2):
            new = mod.inference_net(params, state, torch.bfloat16,
                                    cuda_device, fold=fold)
            sa, sb = new.state_dict(), old.state_dict()
            assert list(sa) == list(sb)
            for k in sa:
                assert sa[k].is_cuda and torch.equal(sa[k], sb[k]), k
            assert torch.equal(new(x), want)


def test_bf16_1d_train_step_lowers_the_loss_on_card(cuda_device):
    """5 bf16 UNet1D train steps (nfb=4, dropout on, wbce pos=2) on one
    fixed batch: the loss stays finite and falls."""
    from deepcalcium_torch.models.unet1d import UNet1D
    from deepcalcium_torch.ops import losses
    from deepcalcium_torch.train import trainer

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    y = (x > 1.0).float()
    model = UNet1D(nfb=4, compute_dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(1)).to(cuda_device)
    step = trainer.make_train_step(
        model, lambda yt, yp: losses.weighted_binary_crossentropy(yt, yp, 2.0),
        trainer.make_optimizer(model, 2e-3), dict(losses.SPIKE_METRICS))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, y = x.to(cuda_device), y.to(cuda_device)
    losses_ = [step(x, y, gen)["loss"].item() for _ in range(5)]
    assert np.isfinite(losses_).all()
    assert losses_[-1] < losses_[0]


@pytest.mark.parametrize("arch", ["glm", "stm"])
def test_glm_models_on_card_match_cpu(cuda_device, arch):
    """The GLM and STM functions on the card against the CPU, rtol 1e-5
    atol 1e-6 (float32 sums in another order)."""
    from deepcalcium_torch.models import glm_spikes as glm

    g = torch.Generator().manual_seed(3)
    params = glm.stm_init(g, 41) if arch == "stm" else glm.glm_init(g, 41)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, 1000)).astype(np.float32))
    fn = glm.stm_apply if arch == "stm" else glm.glm_apply
    cpu = fn(params, x)
    gpu = fn({k: v.to(cuda_device) for k, v in params.items()},
             x.to(cuda_device)).cpu()
    torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-6)


# --- per-frame segmentation and the stencil -----------------------------------

@pytest.mark.parametrize("dtype,shape,slab", [
    (np.int16, (21, 40, 44), 8),     # ragged T; H, W not multiples of 16
    (np.uint16, (9, 37, 50), 4),
    (np.float32, (70, 32, 32), 8),   # more slabs than staging slots
])
def test_segment_movie_on_card_matches_cpu(cuda_device, dtype, shape, slab):
    """The pipelined path on the card (pinned staging, a copy stream, masks
    one slab behind) against the CPU path at float32 with TF32 off: masks
    equal wherever the CPU's probability lies 1e-4 or more from the
    threshold (sums in another order)."""
    from chip_smoke import straightforward_segment
    from deepcalcium_torch.models.movie_segmentation import segment_movie
    from deepcalcium_torch.models.unet2d import from_jax_params, to_jax_params

    rng = np.random.default_rng(11)
    movie = rng.poisson(100, shape).astype(np.float64)
    movie[:, 10:20, 10:20] += 300 * (rng.random((shape[0], 1, 1)) > 0.5)
    movie = (movie * (100 if dtype == np.uint16 else 1)).astype(dtype)
    net = UNet2DS(nfb=4, generator=torch.Generator().manual_seed(3))
    net.head_conv.bias.data = torch.tensor([0.05, -0.05])  # off exact 0.5
    params, state = to_jax_params(net)
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = segment_movie(params, state, movie, slab=slab,
                            compute_dtype=None)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    cpu = segment_movie(params, state, movie, slab=slab, compute_dtype=None,
                        device="cpu")
    _, probs = straightforward_segment(
        from_jax_params(params, state).eval(), movie, torch.device("cpu"), 16)
    far = np.abs(probs - 0.5) >= 1e-4
    assert got.shape == movie.shape and got.dtype == np.uint8
    assert far.mean() > 0.9 and 0 < got.mean() < 1
    np.testing.assert_array_equal(got[far], cpu[far])
    np.testing.assert_array_equal(got[far], (probs > 0.5)[far])


def test_stencil_on_card_matches_cpu(cuda_device):
    """Integer arithmetic throughout: bit for bit."""
    from deepcalcium_torch.ops.mask_summary import (id_map_from_stack,
                                                    mask_summary_stencil)

    rng = np.random.default_rng(2)
    msks = (rng.random((40, 97, 131)) < 0.05).astype(np.int8)
    got = mask_summary_stencil(msks)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), mask_summary_stencil(msks, device="cpu"))
    for a, b in zip(id_map_from_stack(msks), id_map_from_stack(msks, "cpu")):
        assert torch.equal(a.cpu(), b)
