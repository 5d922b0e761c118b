"""Data parallel in the port (``uncrtaints_tpu_torch/parallel``): the process
group from the environment, the mesh, the loader's shards, and 2 and 3 gloo
ranks on the CPU against one process — the counterpart of
``tests/test_multihost.py``.

Tolerances: fp32 throughout. The ranks sum their gradients and the batch
norms' sums in another order than one process does, so losses agree to 1e-6
relative and parameters after each of two Adam steps to 1e-6 absolute,
except where a gradient is zero in exact arithmetic (ROADMAP §3: a
batch-norm PreNorm's bias ahead of a bias-free convolution, the L-TAE biases
under the softmax): there both sides hold rounding noise that Adam turns
into steps of up to lr, so those parameters are held to 2 lr a step. The
batch-norm running statistics are held to 1e-6 after the first step; after
the second they hang on those noise-moved parameters too (the PreNorm bias
shifts the next norm's mean), and only the ranks' equality is held. Ranks
hold parameters and statistics equal to the bit. Eval metrics to 1e-6
relative.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from uncrtaints_tpu_torch.data import BatchLoader
from uncrtaints_tpu_torch.parallel import (
    Mesh, current_mesh, make_mesh, maybe_init_distributed, row_split, shard_batch)
from uncrtaints_tpu_torch.train.loop import _with_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import _torch_parallel_worker as worker  # noqa: E402

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
       "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES",
       "JAX_NUM_PROCESSES", "PROCESS_ID", "JAX_PROCESS_ID")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def test_no_environment_no_process_group(clean_env):
    assert maybe_init_distributed("cpu") == (0, 1)
    assert not dist.is_initialized() and current_mesh() == Mesh(0, 1)


@pytest.mark.parametrize("spelling", ["torchrun", "jax"])
def test_the_environment_starts_a_gloo_group(clean_env, spelling):
    """torchrun's variables, or the JAX package's (mesh.py:44-65), start a
    group of one gloo rank; a second call returns the same."""
    port = _free_port()
    if spelling == "torchrun":
        for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(port)).items():
            clean_env.setenv(k, v)
    else:
        for k, v in dict(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="1",
                         PROCESS_ID="0").items():
            clean_env.setenv(k, v)
    assert maybe_init_distributed("cpu") == (0, 1)
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert maybe_init_distributed("cpu") == (0, 1) and make_mesh(1) == Mesh(0, 1)
    t = torch.ones(3)
    dist.all_reduce(t)  # the collectives run at world size 1
    assert torch.equal(t, torch.ones(3))


def test_make_mesh_refuses_a_shortfall(clean_env):
    assert make_mesh() == Mesh(0, 1) and make_mesh(1).axis_names == ("data",)
    with pytest.raises(RuntimeError, match="requested 2 ranks but only 1"):
        make_mesh(2)


class _Ids:
    """A dataset whose sample i is its own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def _ids(samples, use_sar=True):
    return {"y": np.asarray(samples)}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("n, local_bs", [(11, 2), (5, 2), (12, 2)])
@pytest.mark.parametrize("train", [False, True])
def test_loader_shards_are_disjoint_and_exhaustive(world, n, local_bs, train):
    """Every rank's rows (the strided body, its split of the global tail)
    are disjoint, cover the epoch, and sit at their position of the one
    process's order; a train tail too short for every rank is skipped."""
    one = BatchLoader(_Ids(n), batch_size=local_bs * world, shuffle=True, seed=3,
                      collate=_ids, num_workers=1, drop_last=False)
    order = np.concatenate([b["y"] for b in _with_rows(one, train)])
    seen = {}
    for r in range(world):
        loader = BatchLoader(_Ids(n), batch_size=local_bs, shuffle=True, seed=3,
                             collate=_ids, num_workers=1, drop_last=False,
                             shard=(r, world))
        for b in _with_rows(loader, train):
            for pos, sample in zip(b["_rows"], b["y"]):
                assert pos not in seen
                seen[pos] = sample
    tail = n % (local_bs * world)
    skipped = train and 0 < tail < world
    assert sorted(seen) == list(range(n - tail if skipped else n))
    assert all(order[p] == s for p, s in seen.items()) or skipped


def test_row_split_and_shard_batch():
    assert [row_split(5, r, 3) for r in range(3)] == [(0, 2), (2, 2), (4, 1)]
    assert [row_split(1, r, 2) for r in range(2)] == [(0, 1), (1, 0)]
    batch = {"x": np.arange(10).reshape(5, 2), "dates": torch.arange(5), "flag": True}
    got = shard_batch(batch, Mesh(1, 2))
    assert got["x"].tolist() == [[6, 7], [8, 9]] and got["dates"].tolist() == [3, 4]
    assert got["flag"] is True


def _run_ranks(jobs, world, out_dir):
    """Start ``world`` gloo ranks of the worker running ``jobs`` in order;
    returns each rank's result of each job, {job: [rank 0's, ...]}."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_parallel_worker.py"),
         str(out_dir), *jobs], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    for p in procs:  # wait for every rank, so none outlives the test
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    return {job: [torch.load(os.path.join(out_dir, f"{job}_rank{r}.pt"), weights_only=False)
                  for r in range(world)] for job in jobs}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One start of 2 gloo ranks for the train steps, the eval epoch and the
    CLI run (a start of 3 ranks is the other case of the steps)."""
    out = tmp_path_factory.mktemp("two_ranks")
    return _run_ranks(["steps", "cli"], 2, out), out


@pytest.fixture(scope="module")
def single():
    """One process: the two train steps on the whole global batches, the
    parameters whose first-step gradient is rounding noise (<= 1e-6 of the
    largest: zero in exact arithmetic), and the eval epoch in global batches
    of 4 and of 6 (what 2 and 3 ranks of 2 samples make)."""
    cfg = worker.tiny_cfg()
    losses, states, grads = worker.train_two_steps(cfg, worker.global_batches())
    gmax = max(float(g.abs().max()) for g in grads.values())
    noise = {n for n, g in grads.items() if float(g.abs().max()) <= 1e-6 * gmax}
    evals = {w: worker.eval_epoch(cfg, 2 * w) for w in (2, 3)}
    return states, losses, noise, evals


@pytest.mark.parametrize("world", [2, 3])
def test_gloo_ranks_train_and_evaluate_as_one_process(tmp_path, single, two_ranks, world):
    """``world`` ranks of the train step on their rows of B=5 (3/2 or 2/2/1)
    give the one process's losses, parameters and batch-norm statistics,
    the same on every rank; an eval epoch of 5 samples (a tail split over
    the ranks, one rank without rows at world 2) gathers the one process's
    loss and metrics on every rank."""
    ref_states, ref_losses, noise, evals = single
    ranks = two_ranks[0]["steps"] if world == 2 else _run_ranks(["steps"], 3, tmp_path)["steps"]
    lr = worker.tiny_cfg().lr
    assert any("running_mean" in k for k in ref_states[0])
    for r in ranks:
        assert np.allclose(r["losses"], ref_losses, rtol=1e-6, atol=0), (r["losses"], ref_losses)
        for i, (state, ref) in enumerate(zip(r["states"], ref_states)):
            for k, v in state.items():
                assert torch.equal(v, ranks[0]["states"][i][k]), k  # replicas stay equal
                if "running_" in k and i > 0:
                    continue
                tol = 2 * lr * (i + 1) if k in noise else 1e-6
                assert float((v - ref[k]).abs().max()) <= tol, (k, i, world)
        val_loss, img = evals[world]
        assert r["val_loss"] == pytest.approx(val_loss, rel=1e-6)
        assert set(r["img"]) == set(img)
        for k, v in img.items():
            assert r["img"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


def test_gloo_cli_writes_each_file_once(two_ranks):
    """``cli.train --mesh_shape 2`` over two gloo ranks: checkpoints and
    conf.json come from rank 0 alone; each exported sample from exactly one
    rank; both ranks report the same test metrics."""
    ranks, tmp_path = two_ranks[0]["cli"], two_ranks[1]
    calls = [r["calls"] for r in ranks]
    assert calls[0]["checkpoints"] == ["model", "model_epoch_1"] and calls[0]["conf"] == 1
    assert calls[1]["checkpoints"] == [] and calls[1]["conf"] == 0
    exports = calls[0]["exports"] + calls[1]["exports"]
    assert len(exports) == len(set(exports))
    for split in ("val", "test"):
        ids = sorted(i for s, m, i in exports if s == split and m == "pred")
        assert ids == list(range(worker.GLOBAL_B)), (split, ids)
    assert ranks[0]["test"] == ranks[1]["test"]
    exp = tmp_path / "results" / "dp"
    assert {"conf.json", "model.pth.tar", "model_epoch_1.pth.tar", "test_metrics.json"} <= set(
        os.listdir(exp))
