"""A multi-rank dry run of every parallelism family on tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:40``)
of the JAX package: over ``n`` ranks (spawned gloo ranks on the CPU by
default, or P ranks on one GPU), run

* dp × tp: one Adam step over 2·dp restarts sharded on ``dp``, each
  restart's Gram built as ``tp`` row panels (``sharded_nll``), against the
  same step without a mesh;
* tp: the block-cyclic distributed Cholesky NLL against ``chol.nll``;
* ep: segments (local GP experts) split over ``dp``, their masked NLLs
  summed by one all-reduce, against the batched ``segmented_nll``;
* sp: the mesh-sharded streaming iterative NLL + gradient and chunked
  posterior against the same calls without a mesh.

    python -m gaussianprocessfundamentals_tpu_torch.parallel.dryrun 4
"""
from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from gaussianprocessfundamentals_tpu_torch.parallel.meshes import launch


def _close(a, b, rtol: float, what: str) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not (np.all(np.isfinite(a))
            and np.max(np.abs(a - b)) <= rtol * max(1.0, np.max(np.abs(b)))):
        raise AssertionError(f"dryrun {what}: {a} vs {b}")


def _rank(device: str) -> dict:
    """One rank's dry run; every check raises on failure."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.fit.fit import init_uparams
    from gaussianprocessfundamentals_tpu_torch.fit.transforms import (
        constrain,
    )
    from gaussianprocessfundamentals_tpu_torch.linalg import (
        cholesky as chol,
    )
    from gaussianprocessfundamentals_tpu_torch.models import iterative
    from gaussianprocessfundamentals_tpu_torch.models.segmented import (
        masked_nll,
        pad_segments,
        segmented_nll,
        stacked_gram,
    )
    from gaussianprocessfundamentals_tpu_torch.parallel import sharded
    from gaussianprocessfundamentals_tpu_torch.parallel.block_cholesky import (
        distributed_nll,
    )
    from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
        make_mesh,
    )
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_map

    world = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    dp = 2 if world % 2 == 0 and world >= 2 else 1
    tp = world // dp
    mesh = make_mesh(dp=dp, tp=tp)
    n = max(64, 8 * tp)
    rng = np.random.default_rng(0)
    x64 = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    x = torch.tensor(x64, dtype=torch.float64, device=dev)
    y = torch.sin(6 * x[:, 0])
    kernel = (gpt.SquaredExponentialKernel(scaled=True)
              + gpt.Matern52Kernel()).to(dev)
    pos = kernel.positivity()
    jitter = 1e-6

    # dp × tp: restarts on dp, Gram row panels on tp
    R = 2 * dp
    inits = [init_uparams(kernel, gpt.ZeroMean(), [[0.0, 1.0]], n,
                          generator=torch.Generator().manual_seed(i),
                          dtype=torch.float64, optimize_noise=True,
                          device=dev) for i in range(R)]
    for u in inits:
        u.pop("mean")
    u0 = tree_map(lambda *ls: torch.stack(ls), *inits)

    def nll_one(u, m):
        kernel.set_params(constrain(pos, u["kernel"]))
        noise = torch.exp(u["log_noise"])
        if m is None:
            return chol.nll(kernel.gram(x, x), y, noise, jitter)
        return sharded.sharded_nll(kernel, x, y, noise, jitter, m, "tp")

    opt = sharded.adam(0.05)
    u1, _, losses = sharded.restart_sharded_fit_step(
        lambda u: nll_one(u, mesh), u0, opt.update, opt.init(u0), mesh)
    ref = [float(nll_one(tree_map(lambda l: l[i], u0), None))
           for i in range(R)]
    _close(losses.cpu(), ref, 1e-9, "restart losses")

    # tp: block-cyclic Cholesky NLL against the dense one
    kp1 = constrain(pos, tree_map(lambda l: l[0], u1["kernel"]))
    kernel.set_params(kp1)
    blk = 8
    tp_mesh = make_mesh(dp=1, tp=world)
    nc = blk * world * 2
    with torch.no_grad():
        Kc = kernel.gram(x[:nc], x[:nc])
        nll_bc = distributed_nll(Kc, y[:nc], 0.01, jitter, tp_mesh, "tp", blk)
        nll_ref = chol.nll(Kc, y[:nc], 0.01, jitter)
    _close(float(nll_bc), float(nll_ref), 1e-8, "block-cyclic nll")

    # ep: segments split over dp, masked NLLs all-reduced
    n_seg, seg_len = 2 * dp, 16
    xs = [x[i * seg_len:(i + 1) * seg_len - (i % 2)] for i in range(n_seg)]
    ys = [y[i * seg_len:(i + 1) * seg_len - (i % 2)] for i in range(n_seg)]
    xb, yb, mb = pad_segments(xs, ys)
    kp_seg = tree_map(lambda l: torch.stack([l] * n_seg), kp1)
    with torch.no_grad():
        per = n_seg // dp
        mine = slice(mesh.index("dp") * per, (mesh.index("dp") + 1) * per)
        K_loc = stacked_gram(kernel, tree_map(lambda l: l[mine], kp_seg),
                             xb[mine])
        nll_ep = masked_nll(K_loc, yb[mine], mb[mine], 0.01, jitter).sum()
        dist.all_reduce(nll_ep, group=mesh.group("dp"))
        nll_ep_ref = segmented_nll([kernel] * n_seg, kp_seg, xb, yb, mb, 0.01,
                                   jitter)
    _close(float(nll_ep), float(nll_ep_ref), 1e-10, "segments nll")

    # sp: streaming mesh NLL + gradient and chunked posterior
    k_sp = gpt.SquaredExponentialKernel().to(dev)
    k_sp.set_params({"lengthscale": torch.tensor(0.2, dtype=torch.float64,
                                                 device=dev)})

    def sp_nll(m):
        g = torch.Generator(device=dev).manual_seed(7)
        return iterative.iterative_nll_and_grad(
            k_sp, x, y, 0.1, g, num_probes=4, max_iters=100, precond_m=8,
            mesh=m, mesh_axis="tp")

    nll_sp, g_sp, _, _ = sp_nll(tp_mesh)
    nll_sp0, g_sp0, _, _ = sp_nll(None)
    _close(float(nll_sp), float(nll_sp0), 1e-8, "streaming nll")
    _close(float(g_sp["lengthscale"]), float(g_sp0["lengthscale"]), 1e-8,
           "streaming gradient")
    xt = x[::max(1, n // 16)][:8]
    mu1, var1 = iterative.iterative_posterior_chunked(
        k_sp, x, y, xt, 0.1, precond_m=8, chunk=8, mesh=tp_mesh)
    mu0, var0 = iterative.iterative_posterior_chunked(
        k_sp, x, y, xt, 0.1, precond_m=8, chunk=8)
    _close(mu1.cpu(), mu0.cpu(), 1e-8, "streaming posterior mean")
    _close(var1.cpu(), var0.cpu(), 1e-8, "streaming posterior variance")
    return {"dp": dp, "tp": tp, "n": n, "restarts": R,
            "backend": dist.get_backend(), "losses": losses.cpu().tolist(),
            "block_cyclic_nll": float(nll_bc), "dense_nll": float(nll_ref),
            "ep_segments_nll": float(nll_ep),
            "sp_streaming_nll": float(nll_sp),
            "sp_single_nll": float(nll_sp0),
            "sp_posterior_mu0": float(mu1[0]),
            "jax_free": "jax" not in sys.modules}


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     device: str = "cpu", timeout: float = 300.0,
                     init_method=None) -> dict:
    """Spawn ``n_devices`` ranks and run every family's check on them;
    raises if any check or rank fails. Returns rank 0's summary. It runs on
    CPU gloo ranks unless told otherwise, as the JAX package's dry run runs
    on forced host devices: a check of the multi-chip code paths that needs
    no card."""
    res = launch(_rank, n_devices, (device,), backend=backend, device=device,
                 timeout=timeout, init_method=init_method, threads=1)[0]
    if not res["jax_free"]:
        raise AssertionError("dryrun: a rank imported JAX")
    print(f"dryrun_multichip ok: {res['backend']} x {n_devices} ({device}), "
          f"mesh dp={res['dp']} tp={res['tp']}, n={res['n']}, "
          f"restarts={res['restarts']}, losses={res['losses']}, "
          f"block_cyclic_nll={res['block_cyclic_nll']:.3f} "
          f"(dense {res['dense_nll']:.3f}), "
          f"ep_segments_nll={res['ep_segments_nll']:.3f}, "
          f"sp_streaming_nll={res['sp_streaming_nll']:.3f} "
          f"(single {res['sp_single_nll']:.3f})", flush=True)
    return res


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
