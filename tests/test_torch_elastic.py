"""The train CLI's elastic loop in the port: ``--ckpt`` / ``--ckpt-every``
/ ``--die-at`` / ``--resume`` / ``--losses-out`` / ``--drift-*``, in one
process and on gloo ranks, held to the port's own uninterrupted run (the
JAX package's elastic test fails on every full run: ROADMAP Queue 3)
and, through the checkpoint, to the JAX package's ``loss_fn``.

The reduced llama of the reference harness (``tests/harness_pipe.py``:
8 layers, d_model 64, seq 32, batch 8, M 8), 6 steps, a save every 2
steps, dead after step 3: the resume runs steps 2-5.  Each world size is
spawned once for the module (2 ranks: stages 2; 4 ranks: data 2 x
stages 2 under 2bw), in threads, while this process runs the in-process
cases; one torch thread everywhere.
"""
import concurrent.futures
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLM as JaxLM
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro.pipeline import stage as JST
from repro_torch.checkpoint import (CheckpointMismatch, checkpoint_meta,
                                    checkpoint_step, restore_checkpoint)
from repro_torch.checkpoint.ckpt import CheckpointReader, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train
from repro_torch.pipeline import stage as ST

import _torch_elastic_worker as W

#: the reduced llama of the reference harness, seed 3
BASE = ["--arch", "llama3.2-1b", "--reduced", "--layers", "8", "--d-model",
        "64", "--tensor", "1", "--batch", "8", "--seq", "32", "--log-every",
        "100", "--seed", "3", "--device", "cpu"]
LLAMA = BASE + ["--microbatches", "8", "--steps", "6"]
S8 = LLAMA + ["--stages", "8"]
S4V2 = LLAMA + ["--stages", "4", "--virtual", "2", "--schedule",
                "1f1b-interleaved"]
MAMBA = ["--arch", "mamba2-2.7b", "--reduced", "--layers", "2", "--d-model",
         "64", "--stages", "2", "--microbatches", "2", "--batch", "4",
         "--seq", "32", "--steps", "4", "--log-every", "100", "--device",
         "cpu"]
#: the ranks' runs, 4 steps, M 2 a replica: 2 stages (world 2), data 2 x
#: stages 2 under 2bw (world 4)
RANKS2 = BASE + ["--microbatches", "2", "--steps", "4", "--stages", "2"]
RANKS4 = RANKS2 + ["--data", "2", "--grad-sync", "2bw"]
CASES2 = [
    ("save", RANKS2 + ["--steps", "2", "--ckpt", "{dir}/r2", "--ckpt-every",
                       "2"]),
    ("die", RANKS2 + ["--ckpt", "{dir}/rd", "--ckpt-every", "2", "--die-at",
                      "3"]),
    ("resume", RANKS2 + ["--resume", "{dir}/r2"]),
    ("tensor", RANKS2 + ["--stages", "1", "--tensor", "2", "--resume",
                         "{dir}/r2"]),
]
CASES4 = [
    ("ref", RANKS4),
    ("save", RANKS4 + ["--steps", "2", "--ckpt", "{dir}/d2", "--ckpt-every",
                       "2"]),
    ("die", RANKS4 + ["--ckpt", "{dir}/dd", "--ckpt-every", "2", "--die-at",
                      "3"]),
    ("resume", RANKS4 + ["--resume", "{dir}/dd"]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(argv: list) -> dict:
    """``train.main(argv)`` with its output kept: the result, with the
    text under ``"stdout"``; a ``SystemExit`` comes back as ``{"exit":
    status, "stdout": ...}``."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = train.main(argv)
    except SystemExit as e:
        return dict(exit=e.code, stdout=buf.getvalue())
    return dict(out, stdout=buf.getvalue())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawned = {n: pool.submit(MESH.spawn_ranks, W.run_cases, n, "gloo",
                                  cases, d, data=data)
                   for n, cases, data in ((2, CASES2, 1), (4, CASES4, 2))}
        out = dict(dir=d)
        out["ref"] = _quiet(S8)
        out["die"] = _quiet(S8 + ["--ckpt", f"{d}/ck", "--ckpt-every", "2",
                                  "--die-at", "3", "--losses-out",
                                  f"{d}/died.json"])
        out["meta"] = checkpoint_meta(f"{d}/ck")
        out["same"] = _quiet(S8 + ["--resume", f"{d}/ck", "--losses-out",
                                   f"{d}/same.json"])
        out["moved"] = _quiet(S4V2 + ["--resume", f"{d}/ck"])
        # the ranks' references: the same runs in process
        out["in2"] = _quiet(RANKS2 + ["--steps", "2", "--ckpt", f"{d}/i2",
                                      "--ckpt-every", "2"])
        out["in2 resume"] = _quiet(RANKS2 + ["--resume", f"{d}/i2"])
        out["ranks"] = {n: f.result() for n, f in spawned.items()}
    return out


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

def test_die_at_exits_17_after_saving_at_the_last_boundary(runs):
    assert runs["die"]["exit"] == 17
    assert "fault injection: dying after step 3" in runs["die"]["stdout"]
    assert runs["meta"]["step"] == 2 and checkpoint_step(
        f"{runs['dir']}/ck") == 2
    assert runs["meta"]["extra"] == dict(
        layout=dict(stages=8, tensor=1, virtual=1, layers_per_stage=1,
                    n_layers_padded=8, n_layers=8), arch="llama3.2-1b")
    with open(f"{runs['dir']}/died.json") as f:
        died = json.load(f)
    assert died == dict(start=0, losses=runs["ref"]["losses"][:3])


def test_same_layout_resume_is_the_uninterrupted_run_bit_for_bit(runs):
    same = runs["same"]
    assert same["start"] == 2
    assert same["losses"] == runs["ref"]["losses"][2:]
    for a, b in zip(ST.tree_leaves(same["params"]),
                    ST.tree_leaves(runs["ref"]["params"])):
        assert torch.equal(a, b)


def test_losses_out_starts_at_the_resumed_step(runs):
    with open(f"{runs['dir']}/same.json") as f:
        assert json.load(f) == dict(start=2,
                                    losses=runs["ref"]["losses"][2:])


def test_resume_across_layouts_reshards_on_the_host(runs):
    """8 x V 1 -> 4 x V 2: the checkpoint is resharded into
    ``ck.to4v2`` and the run goes on from step 2.  Bit for bit here (the
    clip norm's per-stage sum, ROADMAP "A deliberate difference", moves
    no bit at this size); the bar is 1e-6 relative."""
    moved, ref = runs["moved"], runs["ref"]["losses"][2:]
    assert "resharded checkpoint: stages8 x virtual1 -> stages4 x virtual2" \
        in moved["stdout"]
    assert moved["start"] == 2 and len(moved["losses"]) == 4
    assert max(abs(a - b) / abs(b) for a, b in zip(moved["losses"], ref)) \
        <= 1e-6
    assert moved["losses"] == ref
    layout = checkpoint_meta(f"{runs['dir']}/ck.to4v2")["extra"]["layout"]
    assert (layout["stages"], layout["virtual"]) == (4, 2)


def test_mamba2_resumes_bit_for_bit(tmp_path):
    ref = _quiet(MAMBA)
    died = _quiet(MAMBA + ["--ckpt", str(tmp_path / "m"), "--ckpt-every",
                           "2", "--die-at", "3"])
    assert died["exit"] == 17
    with CheckpointReader(str(tmp_path / "m")) as ck:
        assert ck.meta["dtypes"]["params/layers/ssm/a_log"] == "float32"
        assert "opt/m/layers/ssm/dt_bias" in ck.keys
    res = _quiet(MAMBA + ["--resume", str(tmp_path / "m")])
    assert res["start"] == 2 and res["losses"] == ref["losses"][2:]


def test_port_checkpoint_gives_the_jax_loss_fn_its_loss(runs):
    """The port's checkpoint at step 2, restored by the JAX package:
    ``loss_fn`` on batch 2 within the harness bar (1e-4) of the loss the
    port logged at step 2."""
    cfg = dataclasses.replace(jax_get_config("llama3.2-1b").reduced(
        n_layers=8, d_model=64, seq=32), stages=8, tensor=1)
    plan = JST.plan_stages(cfg)
    params = JST.init_stacked_params(cfg, jax.random.PRNGKey(0), plan)
    like = dict(params=params, opt=JAdamW().init(params))
    state = jax_restore(f"{runs['dir']}/ck", like)
    p = state["params"]
    rp = dict(embed=p["embed"], final_norm=p["final_norm"],
              layers=jax.tree.map(
                  lambda a: JST.unstack_chunks(a, plan)[:cfg.n_layers],
                  p["layers"]))
    if "head" in p:
        rp["head"] = p["head"]
    batch = JaxLM(vocab=cfg.vocab, seq_len=32, global_batch=8,
                  seed=3).batch(2)
    loss = float(JM.loss_fn(cfg, rp, batch))
    assert abs(loss - runs["ref"]["losses"][2]) < 1e-4
    assert int(state["opt"]["step"]) == 2


def test_drift_monitor_trips_and_prints_the_replan():
    """The JAX harness's ``elastic_drift`` argv: 4 stages, the first made
    4x slower; three updates (steps 1, 3, 5) before the monitor may
    trip."""
    out = _quiet(["--arch", "llama3.2-1b", "--reduced", "--layers", "8",
                  "--d-model", "64", "--data", "1", "--stages", "4",
                  "--tensor", "1", "--microbatches", "4", "--steps", "8",
                  "--batch", "4", "--seq", "32", "--log-every", "100",
                  "--drift-every", "2", "--drift-inject", "4,1,1,1",
                  "--drift-threshold", "0.25", "--replan-budget", "20",
                  "--device", "cpu"])
    assert [s for s, _ in out["drift"]["drifts"]] == [1, 3, 5]
    assert out["drift"]["replan"].startswith("drift 1.29 at step 5: replan")
    assert out["stdout"].count("replan") == 1
    assert len(out["losses"]) == 8


def test_wrong_drift_inject_length_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        train.main(S8[:-2] + ["--stages", "4", "--drift-every", "2",
                              "--drift-inject", "4,1"])
    assert e.value.code == 2
    assert "--drift-inject needs 4 factors, got 2" in capsys.readouterr().err


def test_resume_refuses_a_checkpoint_without_layout(tmp_path):
    save_checkpoint(str(tmp_path / "x"), dict(w=torch.zeros(2)))
    with pytest.raises(CheckpointMismatch, match="records no layout"):
        train.main(S8 + ["--resume", str(tmp_path / "x")])


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------

def _same_files(a: str, b: str) -> None:
    """The two checkpoints' metas byte for byte, their arrays bit for
    bit."""
    with open(a + ".meta", "rb") as f, open(b + ".meta", "rb") as g:
        assert f.read() == g.read()
    with CheckpointReader(a) as x, CheckpointReader(b) as y:
        assert x.keys == y.keys
        for k in x.keys:
            u, v = x.array(k), y.array(k)
            assert u.dtype == v.dtype and np.array_equal(u, v), k


def test_rank_written_checkpoint_is_the_in_process_one(runs):
    d = runs["dir"]
    ranks = runs["ranks"][2]
    assert [r["save"]["losses"] for r in ranks] == \
        [runs["in2"]["losses"]] * 2
    _same_files(f"{d}/r2", f"{d}/i2")


def test_rank_resume_is_the_in_process_resume(runs):
    for r in runs["ranks"][2]:
        assert r["resume"]["start"] == 2
        assert r["resume"]["losses"] == runs["in2 resume"]["losses"]


def test_every_rank_exits_17_at_die_at(runs):
    assert [r["die"] for r in runs["ranks"][2]] == [dict(exit=17)] * 2
    assert [r["die"] for r in runs["ranks"][4]] == [dict(exit=17)] * 4
    assert checkpoint_step(f"{runs['dir']}/rd") == 2


def test_tensor_change_on_resume_raises_on_every_rank(runs):
    for r in runs["ranks"][2]:
        assert "tensor degree change" in r["tensor"]["error"]


def _joined_2bw(runs) -> dict:
    """Replica 0's shares of the data-2 run's state after 2 steps, joined
    into the stacked tree (``stage.join_shares``)."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(
        n_layers=8, d_model=64, seq=32), stages=2, tensor=1)
    ranks = runs["ranks"][4]
    return ST.join_shares([[ranks[s]["save"]["state"]] for s in range(2)],
                          cfg, ST.plan_stages(cfg))


def test_data_2_by_2bw_writes_replica_0s_joined_state(runs, tmp_path):
    """data 2 x stages 2 under 2bw: the rank-written file is the file
    written in process from replica 0's shares joined: params, moments,
    ``pending`` and ``primed``."""
    whole = _joined_2bw(runs)
    assert whole["opt"]["primed"].item() is True
    save_checkpoint(str(tmp_path / "joined"), whole, step=2,
                    extra=checkpoint_meta(f"{runs['dir']}/d2")["extra"])
    _same_files(f"{runs['dir']}/d2", str(tmp_path / "joined"))
    ranks = runs["ranks"][4]        # replica 1 holds what replica 0 holds
    for s in range(2):
        for a, b in zip(ST.tree_leaves(ranks[s]["save"]["state"]),
                        ST.tree_leaves(ranks[2 + s]["save"]["state"])):
            assert torch.equal(a, b)


def test_data_2_by_2bw_resume_is_the_uninterrupted_run(runs):
    for r in runs["ranks"][4]:
        assert r["resume"]["start"] == 2
        assert r["resume"]["losses"] == r["ref"]["losses"][2:]
    back = restore_checkpoint(f"{runs['dir']}/d2", _joined_2bw(runs),
                              device="cpu")
    assert back["opt"]["inner"]["step"].dtype == torch.int32
    assert back["opt"]["primed"].dtype == torch.bool
