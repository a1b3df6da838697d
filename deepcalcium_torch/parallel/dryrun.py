"""Every multi-device path once, on tiny shapes, over a given mesh.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:

    python -m deepcalcium_torch.parallel.dryrun --rank R --world N \\
        --port P --device cpu|cuda --out FILE

is one rank of N (start all N; ``--device cpu`` runs them on gloo, ``cuda``
one rank a card on NCCL). :func:`spawn` starts the N ranks as subprocesses
and collects their files.

On nfb=4 nets, 32x32 windows and traces of 64 samples it runs the UNet2DS
and UNet1D train steps (drp=0, so that one process is reproduced), a second
2-D step fed through ``global_batch_from_local``, two UNet2DS steps in one
``make_multi_step`` call beside the same two through ``make_train_step``,
the three losses that are not linear in their sums, the sharded summary at
even and ragged T and at T = 1, ``_run_batched``, ``predict_tta``, the
movie evaluator, ``segment_movie``, and two short epochs of both wrappers'
``fit`` (rank 0 alone writes the checkpoints) with the spike ``predict``
(on the folded net, its default for a ``UNet1D``).
The lane-packed paths of the JAX dry run are not ported, and so are not
here.

Each rank writes its losses, gradients, buffers, weights and outputs to its
``--out`` file (an ``.npz``). :func:`dryrun_multichip` with ``mesh=None``
runs the same paths in one process without a mesh, which is what the tests
hold the ranks' files against.
"""

import argparse
import functools
import os
import subprocess
import sys

import numpy as np
import torch

__all__ = ["make_inputs", "tiny_nets", "dryrun_multichip", "spawn"]

BATCH = 8  # rows of every global batch: worlds of 1, 2, 4 and 8 divide it
ADAM = dict(lr=2e-3, betas=(0.9, 0.999), eps=1e-4)
# The wrappers' Adam has eps 1e-8: a weight whose gradient is rounding-size
# moves by the learning rate a step, in a direction set by rounding. A small
# rate keeps two runs that sum in another order close.
FIT_LR = 1e-4
SUMMARY_CASES = (("i16_even", "movie_i16", 16), ("i16_ragged", "movie_i16", 13),
                 ("i16_one", "movie_i16", 1), ("u16_ragged", "movie_u16", 13),
                 ("f32_ragged", "movie_f32", 13))


def make_inputs() -> dict:
    """The dry run's inputs as numpy arrays, from a fixed seed. The first
    four are the batches of the JAX package's two-process test."""
    gen = np.random.default_rng(0)
    out = {
        "x1": gen.standard_normal((BATCH, 64)).astype(np.float32),
        "y1": (gen.random((BATCH, 64)) < 0.1).astype(np.float32),
        "x2": gen.standard_normal((BATCH, 32, 32)).astype(np.float32),
        "y2": (gen.random((BATCH, 32, 32)) < 0.1).astype(np.float32),
        # Predictions strictly inside (0, 1) for the losses, and labels
        # that are dense in the first half of the batch and sparse in the
        # second, so that a mean of per-rank losses is another number.
        "yp": gen.uniform(0.05, 0.95, (BATCH, 32, 32)).astype(np.float32),
        "yl": (gen.random((BATCH, 32, 32)) < np.where(
            np.arange(BATCH) < BATCH // 2, 0.4, 0.02)[:, None, None]
        ).astype(np.float32),
        "images": gen.standard_normal((5, 32, 32)).astype(np.float32),
        "tta0": gen.standard_normal((32, 32)).astype(np.float32),
        "tta1": gen.standard_normal((20, 28)).astype(np.float32),
    }
    movie = gen.poisson(100, (16, 32, 32)).astype(np.float64)
    for _ in range(3):
        cy, cx = gen.integers(4, 28, 2)
        movie[gen.random(16) > 0.5, cy - 3:cy + 4, cx - 3:cx + 4] += 400
    out["movie_i16"] = movie.astype(np.int16)
    out["movie_u16"] = (movie * 100).astype(np.uint16)  # past 32767
    out["movie_f32"] = (movie + gen.random(movie.shape)).astype(np.float32)
    return out


def tiny_nets(device="cpu"):
    """(UNet2DS, UNet1D) at nfb=4, drp=0, float32, from a fixed seed, with
    head biases: with zero ones a position whose head inputs are all ReLU
    zeros has a probability of exactly 0.5, which a last bit tips."""
    from deepcalcium_torch.models.unet1d import UNet1D
    from deepcalcium_torch.models.unet2d import UNet2DS

    net2 = UNet2DS(nfb=4, drp=0.0, generator=torch.Generator().manual_seed(0))
    net1 = UNet1D(nfb=4, margin=4, drp=0.0,
                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net2.head_conv.bias.copy_(torch.tensor([0.05, -0.05]))
        net1.head_conv.bias.copy_(torch.tensor([0.1, -0.1]))
    return net2.to(device), net1.to(device)


def _np(t):
    """A host copy: a CPU tensor's own memory changes with the next step."""
    return np.array(t.detach().cpu().numpy())


def _record_net(out, prefix, net):
    for name, p in net.named_parameters():
        out[f"{prefix}.grad.{name}"] = _np(p.grad)
        out[f"{prefix}.param.{name}"] = _np(p)
    for name, b in net.named_buffers():
        out[f"{prefix}.buf.{name}"] = _np(b)


def dryrun_multichip(mesh=None, device=None, workdir=None) -> dict:
    """Run every multi-device path once over ``mesh`` (None: the same paths
    in one process, without a mesh) and return ``{name: ndarray}``: the
    losses, metrics, gradients, BN buffers, weights after the step and
    outputs, for the caller to compare across ranks and against one
    process. With a ``workdir`` (one that every rank sees) both wrappers'
    ``fit`` run too and write their checkpoints there."""
    from deepcalcium_torch.models.movie_segmentation import segment_movie
    from deepcalcium_torch.models.unet2d import to_jax_params
    from deepcalcium_torch.ops import losses as L
    from deepcalcium_torch.ops.summary import (movie_summary_fast,
                                               movie_summary_sharded)
    from deepcalcium_torch.parallel.distributed import global_batch_from_local
    from deepcalcium_torch.parallel.mesh import all_gather, shard_batch
    from deepcalcium_torch.train import trainer as T
    from deepcalcium_torch.train.evaluate import (_run_batched,
                                                  make_movie_evaluator,
                                                  predict_tta)

    device = torch.device(device if device is not None
                          else mesh.device if mesh is not None else "cpu")
    size = mesh.size if mesh is not None else 1
    inp = make_inputs()
    dev = {k: torch.from_numpy(v).to(device) for k, v in inp.items()
           if not k.startswith("movie")}
    out = {"world": np.int64(size)}

    # The train steps, every rank handed the whole batch.
    net2, net1 = tiny_nets(device)
    opt2 = torch.optim.Adam(net2.parameters(), **ADAM)
    step2 = T.make_train_step(net2, L.LOSSES["binary_crossentropy"], opt2,
                              mesh=mesh)
    met = step2(dev["x2"], dev["y2"])
    out.update({f"u2d.metric.{k}": _np(v) for k, v in met.items()})
    _record_net(out, "u2d", net2)
    # A second step, each rank feeding only its own rows.
    if mesh is not None:
        xl, yl = global_batch_from_local(
            mesh, shard_batch(mesh, (inp["x2"], inp["y2"])))
    else:
        xl, yl = dev["x2"], dev["y2"]
    out["u2d.loss_local_feed"] = _np(step2(xl, yl)["loss"])

    opt1 = torch.optim.Adam(net1.parameters(), **ADAM)
    step1 = T.make_train_step(
        net1, functools.partial(L.weighted_binary_crossentropy, weightpos=2.0),
        opt1, dict(L.SPIKE_METRICS), mesh=mesh)
    met = step1(dev["x1"], dev["y1"])
    out.update({f"u1d.metric.{k}": _np(v) for k, v in met.items()})
    _record_net(out, "u1d", net1)

    # Two 2-D steps in one make_multi_step call, and the same two through
    # make_train_step, each from fresh weights, every rank handed the
    # whole (2, B, ...) slab.
    xs = torch.stack([dev["x2"], dev["x2"].flip(1)])
    ys = torch.stack([dev["y2"], dev["y2"].flip(1)])
    for tag in ("multi", "steps"):
        net, _ = tiny_nets(device)
        opt = torch.optim.Adam(net.parameters(), **ADAM)
        bce = L.LOSSES["binary_crossentropy"]
        if tag == "multi":
            loss = T.make_multi_step(net, bce, opt, 2, mesh=mesh)(xs, ys)["loss"]
        else:
            step = T.make_train_step(net, bce, opt, mesh=mesh)
            loss = torch.stack([step(xs[k], ys[k])["loss"] for k in range(2)])
        out[f"k2.{tag}.loss"] = _np(loss)
        _record_net(out, f"k2.{tag}", net)

    # Losses that are not linear in their sums, and their gradients: a
    # rank's gradient is mesh.size times its rows' (``parallel.mesh.psum``).
    for name, fn in (("jacc", L.jacc_loss), ("dice", L.dice_loss),
                     ("dicesq", L.dicesq_loss)):
        yt, yp = dev["yl"], dev["yp"]
        if mesh is not None:
            yt, yp = shard_batch(mesh, (yt, yp))
        yp = yp.clone().requires_grad_(True)
        loss = L.with_mesh(fn, mesh)(yt, yp)
        loss.backward()
        grad = yp.grad / size
        out[f"loss.{name}"] = _np(loss)
        out[f"loss.{name}.grad"] = _np(all_gather(grad, mesh)
                                       if mesh is not None else grad)

    # The sharded summary: even T, ragged T, fewer frames than ranks.
    for case, key, t in SUMMARY_CASES:
        movie = inp[key][:t]
        if mesh is not None:
            mean, mx = movie_summary_sharded(movie, mesh, chunk=4)
        else:
            mean, mx = movie_summary_fast(torch.from_numpy(movie).to(device))
        out[f"summary.{case}.mean"], out[f"summary.{case}.max"] = _np(mean), _np(mx)

    # Sharded evaluation, on a fresh net in eval mode.
    net, _ = tiny_nets(device)
    fwd = T.make_eval_forward(net.eval(), mesh)
    out["run_batched"] = _np(_run_batched(fwd, dev["images"], max_batch=3,
                                          mesh=mesh))
    probs = predict_tta(fwd, [inp["tta0"], inp["tta1"]], device,
                        window=(32, 32), mesh=mesh)
    out["tta.0"], out["tta.1"] = probs
    ragged = torch.from_numpy(inp["movie_i16"][:13]).to(device)
    mask, prob, mean = make_movie_evaluator(net, ragged.shape, window=(32, 32),
                                            mesh=mesh)(ragged)
    out["evaluator.mask"], out["evaluator.prob"] = _np(mask), _np(prob)
    out["evaluator.mean"] = _np(mean)

    # Per-frame segmentation of 5 frames: whole slabs and a short one.
    params, state = to_jax_params(net)
    slab = 2 * size if mesh is not None else 4
    out["segment"] = segment_movie(params, state, inp["movie_i16"][:5],
                                   slab=slab, mesh=mesh, compute_dtype=None,
                                   device=device)
    if size > 1:
        try:
            segment_movie(params, state, inp["movie_i16"], slab=size + 1,
                          mesh=mesh, compute_dtype=None, device=device)
        except ValueError:
            out["segment.slab_refused"] = np.int64(1)
    if workdir is not None:
        out.update(_fit_wrappers(mesh, device, workdir))
    return out


def _fit_wrappers(mesh, device, workdir) -> dict:
    """Both wrappers' ``fit`` over the mesh, on data handed in through
    their injection points: two epochs' losses, the best checkpoint's name
    and whether this rank sees the file when ``fit`` returns (rank 0 alone
    writes it, and a barrier stands before the return)."""
    from deepcalcium_torch.models.unet1d import UNet1D
    from deepcalcium_torch.models.unet2d import UNet2DS
    from deepcalcium_torch.models.unet_1d_segmentation import UNet1DSegmentation
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary

    gen = np.random.default_rng(1)
    S, M = {}, {}
    for name in ("a", "b"):
        M[name] = np.zeros((64, 64), np.uint8)
        for cy, cx in gen.integers(6, 58, (8, 2)):
            M[name][cy - 3:cy + 4, cx - 3:cx + 4] = 1
        S[name] = (gen.standard_normal((64, 64)) + 2.0 * M[name]).astype(np.float32)
    model = UNet2DSummary(
        cpdir=os.path.join(workdir, "cp2d"), device=device,
        dataset_name_func=lambda n: n, series_summary_func=S.__getitem__,
        mask_summary_func=M.__getitem__,
        net_func=functools.partial(UNet2DS, nfb=4, drp=0.0))
    hist, best = model.fit(list(S), shape_trn=(32, 32), shape_val=(64, 64),
                           batch_size_trn=BATCH, nb_steps_trn=2, nb_epochs=2,
                           learning_rate=FIT_LR, seed=2, mesh=mesh)
    out = {"fit2d.loss": np.array(hist["loss"]),
           "fit2d.val": np.array(hist["val_nf_f1_mean"]),
           "fit2d.best": np.array(os.path.basename(best).split("_", 1)[1]),
           "fit2d.best_exists": np.int64(os.path.exists(best))}

    spikes = (gen.random((12, 200)) < 0.05).astype(np.float32)
    traces = (spikes * 3.0 + 0.2 * gen.standard_normal(spikes.shape)
              ).astype(np.float32)
    model = UNet1DSegmentation(
        cpdir=os.path.join(workdir, "cp1d"), device=device,
        dataset_attrs_func=lambda n: {"name": n},
        dataset_traces_func=lambda n: traces,
        dataset_spikes_func=lambda n: spikes,
        net_func=functools.partial(UNet1D, nfb=4, drp=0.0))
    mt, mv, best = model.fit(["t"], shape=(64,), batch=BATCH, nb_epochs=2,
                             learning_rate=FIT_LR, seed=2, mesh=mesh)
    out.update({"fit1d.trn_ytspks": np.float64(mt["ytspks"]),
                "fit1d.val_F2": np.float64(mv["F2"]),
                "fit1d.best": np.array(os.path.basename(best).split("_", 1)[1]),
                "fit1d.best_exists": np.int64(os.path.exists(best))})
    pred, _ = model.predict(["t"], best, batch=5, mesh=mesh)
    out["fit1d.predict"] = pred[0]
    return out


def spawn(world: int, device: str, out_dir: str, timeout: float = 300.0):
    """Start ``world`` ranks of this module as subprocesses on a free local
    port, wait for them, and stop whatever still runs.

    # Returns
        (files, runs): each rank's output file, and each rank's
        ``(return code, stdout, stderr)``; the code is 124 for every rank
        when the time limit was reached. A rank prints ``MESH_OK`` once the
        group has formed.
    """
    from deepcalcium_torch.parallel.distributed import _free_port

    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    files = [os.path.join(out_dir, f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deepcalcium_torch.parallel.dryrun",
         "--rank", str(r), "--world", str(world), "--port", str(port),
         "--device", device, "--out", files[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    runs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            runs.append((p.returncode, so, se))
    except subprocess.TimeoutExpired:
        runs = []
        for p in procs:
            p.kill()
            so, se = p.communicate()
            runs.append((124, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return files, runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from deepcalcium_torch.parallel.distributed import (initialize, pod_mesh,
                                                        shutdown)

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share one machine
    else:
        # float32 as written, for the comparison with one process.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
               device=args.device)
    mesh = pod_mesh()
    if mesh.size != args.world:
        raise RuntimeError(f"the group has {mesh.size} ranks, not {args.world}")
    mesh.barrier()
    print("MESH_OK", flush=True)
    out = dryrun_multichip(mesh, workdir=os.path.dirname(
        os.path.abspath(args.out)))
    np.savez(args.out, **out)
    shutdown()
    print(f"dryrun OK: rank {args.rank} of {args.world} on {mesh.device}, "
          f"unet2d loss {float(out['u2d.metric.loss']):.4f}, "
          f"unet1d loss {float(out['u1d.metric.loss']):.4f}", flush=True)


if __name__ == "__main__":
    main()
