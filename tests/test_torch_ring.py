"""Ring and context-parallel attention over a gloo process group on the CPU,
against the JAX ops under ``shard_map`` on the 8-device CPU mesh.

The ranks are subprocesses of this file (``python tests/test_torch_ring.py
--rank R --world N ...``), so they import torch and the port and never jax.
They join one gloo group through a file store, take their sequence shard of
the same numpy inputs, run ``ring_attention`` and ``context_parallel_attention``
forward and backward, and write their shards of the outputs and gradients
to ``.npz`` files. The test process runs the JAX ops and assembles the
shards. Bounds: the forward within 5e-3 of the JAX ops (the bound of
tests/test_ring_attention.py), the q/k/v gradients within 1e-4 of fp32
autograd of ``attention_reference`` on the whole sequence.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

B, H, S, D = 1, 2, 256, 32  # as tests/test_ring_attention.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 60


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4)]


def run_ranks(world, tmp_path, script, extra=()):
    """Run ``script`` as ``world`` gloo ranks (file store under ``tmp_path``);
    every rank must exit 0 within RANK_TIMEOUT_S."""
    # one thread a rank: the ranks share the box's cores, and tiny products
    # slow down by an order of magnitude when every rank spreads over all
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, script, "--rank", str(r), "--world", str(world),
                               "--store", str(store), "--dir", str(tmp_path), *extra],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    """(world, the ranks' outputs and gradients assembled along S)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    np.savez(tmp / "inputs.npz", *_inputs())
    run_ranks(world, tmp, os.path.abspath(__file__))
    shards = [np.load(tmp / f"rank{r}.npz") for r in range(world)]
    return world, {k: np.concatenate([s[k] for s in shards], axis=2) for k in shards[0].files}


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX ring and all-gather ops under shard_map on the 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from adv_grpo_tpu.ops.ring_attention import context_parallel_attention, ring_attention

    q, k, v, _ = (jnp.asarray(a) for a in _inputs())
    mesh = Mesh(np.array(jax.devices()), ("sp",))
    spec = P(None, None, "sp", None)
    out = {}
    for name, op in (("ring", ring_attention), ("cp", context_parallel_attention)):
        f = shard_map(lambda q, k, v, op=op: op(q, k, v, axis_name="sp"), mesh=mesh,
                      in_specs=(spec,) * 3, out_specs=spec, check_rep=False)
        out[name] = np.asarray(f(q, k, v))
    return out


@pytest.fixture(scope="module")
def reference_grads():
    import torch

    from adv_grpo_torch.ops.attention import attention_reference

    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention_reference(*leaves, sm_scale=D ** -0.5)
    return [g.numpy() for g in torch.autograd.grad(o, leaves, do)]


@pytest.mark.parametrize("op", ["ring", "cp"])
def test_forward_matches_jax_shard_map(ranks, jax_outputs, op):
    _, out = ranks
    np.testing.assert_allclose(out[f"{op}_o"], jax_outputs[op], atol=5e-3)


@pytest.mark.parametrize("op", ["ring", "cp"])
def test_gradients_match_attention_reference(ranks, reference_grads, op):
    _, out = ranks
    for name, want in zip(("dq", "dk", "dv"), reference_grads):
        np.testing.assert_allclose(out[f"{op}_{name}"], want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{op} {name}")


def test_every_rank_launched_no_kernel(ranks):
    """The CPU ranks run the plain versions: the kernel counters stayed 0."""
    world, out = ranks
    np.testing.assert_array_equal(out["launches"], np.zeros((1, 3, world)))


# ── a rank (run as a script; imports torch and the port, never jax) ──────


def _rank_main(args):
    import torch

    from adv_grpo_torch.ops import attention
    from adv_grpo_torch.ops.ring_attention import context_parallel_attention, ring_attention
    from adv_grpo_torch.parallel import mesh

    mesh.init_distributed("gloo", init_method=f"file://{args.store}", world_size=args.world,
                          rank=args.rank, timeout_s=RANK_TIMEOUT_S)
    assert (mesh.world_size(), mesh.rank()) == (args.world, args.rank)
    inputs = np.load(os.path.join(args.dir, "inputs.npz"))
    n = S // args.world
    sl = slice(args.rank * n, (args.rank + 1) * n)
    q, k, v, do = (torch.from_numpy(inputs[f"arr_{i}"][:, :, sl].copy()) for i in range(4))
    out = {}
    for name, op in (("ring", ring_attention), ("cp", context_parallel_attention)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = op(*leaves)
        grads = torch.autograd.grad(o, leaves, do)
        out[f"{name}_o"] = o.detach().numpy()
        for g_name, g in zip(("dq", "dk", "dv"), grads):
            out[f"{name}_{g_name}"] = g.numpy()
    # one column per rank once the shards are joined along axis 2
    out["launches"] = np.array([attention.mha.launches, attention.mha.cross_launches,
                                attention.mha_bwd.launches], np.int64).reshape(1, 3, 1)
    np.savez(os.path.join(args.dir, f"rank{args.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--dir", required=True)
    _rank_main(ap.parse_args())
