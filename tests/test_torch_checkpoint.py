"""The port's checkpoints against the JAX package's (``repro.checkpoint``)
and ``msgpack``: the msgpack subset byte for byte, files crossing
between the packages bit for bit in both directions (f32 and bf16
trees, the int32 AdamW step, 2bw's state) with byte-equal ``.meta``
sidecars, ``reshard_checkpoint`` byte-equal to the JAX package's over
the reference's layout sweep (``tests/test_reshard.py``), the refusals,
the rank-share joins, and the import isolation of the checkpoint and
the train CLI (no ``jax``, ``msgpack``, ``ml_dtypes`` or ``repro``).
"""
import dataclasses
import itertools
import math
import os
import pathlib
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # tier-1 must collect without hypothesis
    from _hypo_shim import given, settings, strategies as st

from repro import checkpoint as JC
from repro.configs import get_config as jax_get_config
from repro.optim import AdamW as JAdamW
from repro.pipeline import runtime as JRT
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import (CheckpointMismatch, checkpoint_meta,
                                    layout_dict, reshard_checkpoint,
                                    reshard_tree, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import CheckpointReader
from repro_torch.configs import get_config
from repro_torch.pipeline import stage as ST

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

#: every width boundary of the subset's encodings
_EDGES = (
    [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
     -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    + ["", "a" * 31, "a" * 32, "é" * 127, "a" * 255, "a" * 256,
       "a" * 65535, "a" * 65536]
    + [list(range(15)), list(range(16)), [None] * 65535, [True] * 65536]
    + [{f"k{i}": i for i in range(n)} for n in (0, 15, 16, 65535, 65536)]
    + [0.0, -1.5, 1e300, float("inf"), True, False, None,
       (1, "tuple", [2.5])])


@pytest.mark.parametrize("obj", _EDGES, ids=lambda o: (
    f"{type(o).__name__}-{len(o) if hasattr(o, '__len__') else o}"))
def test_msgpack_subset_is_msgpacks_bytes(obj):
    data = _msgpack.packb(obj)
    assert data == msgpack.packb(obj)
    assert _msgpack.unpackb(data) == msgpack.unpackb(data)


def _draw(rng: random.Random, depth: int = 0):
    """One random object of the subset, nested up to 3 deep."""
    kind = rng.randrange(8 if depth < 3 else 6)
    if kind == 0:
        return rng.choice([None, True, False])
    if kind == 1:
        bits = rng.choice([5, 7, 8, 15, 16, 31, 32, 63])
        return rng.randrange(-2**bits, 2**(bits + 1) if bits < 63
                             else 2**64)
    if kind == 2:
        return rng.uniform(-1e6, 1e6)
    if kind in (3, 4):
        n = rng.choice([0, 1, 31, 32, 300])
        return "".join(chr(rng.choice([0x41, 0xe9, 0x4e2d, 0x1f600]))
                       for _ in range(n))
    if kind == 5:
        return rng.choice([0.5, -0.0, 2**70, -2**63])
    n = rng.choice([0, 3, 15, 16, 17])
    if kind == 6:
        return [_draw(rng, depth + 1) for _ in range(n)]
    return {f"k{i}": _draw(rng, depth + 1) for i in range(n)}


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_msgpack_subset_sweep(seed):
    obj = _draw(random.Random(seed))
    try:
        want = msgpack.packb(obj)
    except OverflowError:
        with pytest.raises(OverflowError):
            _msgpack.packb(obj)
        return
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want)


@pytest.mark.parametrize("obj,err", [
    (b"bytes", TypeError), ({1: 2}, TypeError), ({"a": {3}}, TypeError),
    (np.int64(3), TypeError), (2**64, OverflowError),
    (-2**63 - 1, OverflowError)])
def test_msgpack_subset_refuses_other_types(obj, err):
    with pytest.raises(err):
        _msgpack.packb(obj)


@pytest.mark.parametrize("data", [b"\x01\x02", b"\x92\x01", b"\xc4\x01a",
                                  msgpack.packb({1: 2})])
def test_msgpack_subset_reader_refuses_what_it_cannot_read(data):
    with pytest.raises(ValueError):
        _msgpack.unpackb(data)


# ---------------------------------------------------------------------------
# checkpoints between the two packages
# ---------------------------------------------------------------------------

def _jax_state(dtype, two_bw: bool):
    """The JAX package's training state: ``init_stacked_params`` (a
    reduced llama, 4 layers on 2 stages) and ``AdamW.init``, 2bw-wrapped
    or not; numpy leaves, the same tree as the port's."""
    cfg = dataclasses.replace(jax_get_config("llama3.2-1b").reduced(
        n_layers=4, d_model=64), stages=2, tensor=1)
    plan = JST.plan_stages(cfg)
    params = JST.init_stacked_params(cfg, jax.random.PRNGKey(0), plan,
                                     dtype=dtype)
    opt = JAdamW().init(params)
    opt = dict(opt, step=jnp.asarray(5, jnp.int32))
    if two_bw:
        opt = JRT.init_2bw_state(opt, params)
        opt = dict(opt, primed=jnp.asarray(True))
    return jax.tree.map(np.asarray, dict(params=params, opt=opt))


_STATES = [pytest.param(dt, bw, id=f"{dt.__name__}{'-2bw' if bw else ''}")
           for dt in (jnp.float32, jnp.bfloat16) for bw in (False, True)]
_EXTRA = dict(layout=dict(stages=2, tensor=1, virtual=1, layers_per_stage=2,
                          n_layers_padded=4, n_layers=4), arch="llama3.2-1b")


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _assert_same_leaves(port: dict, ref: dict):
    """The port's tree (tensors) equals the JAX side's (numpy) bit for
    bit, dtype included."""
    flat = lambda t: sorted(jax.tree_util.tree_flatten_with_path(t)[0],
                            key=lambda kv: jax.tree_util.keystr(kv[0]))
    got, want = flat(convert.to_jax(port)), flat(ref)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(_bits(a), _bits(b)), k


@pytest.mark.parametrize("dtype,two_bw", _STATES)
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype, two_bw):
    ref = _jax_state(dtype, two_bw)
    JC.save_checkpoint(str(tmp_path / "j"), ref, step=5, extra=_EXTRA)
    like = convert.from_jax(ref, device="cpu")
    got = restore_checkpoint(str(tmp_path / "j"), like, device="cpu")
    _assert_same_leaves(got, ref)
    assert got["params"]["embed"].dtype == (
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype,two_bw", _STATES)
def test_port_checkpoint_restores_in_jax_with_the_same_meta(tmp_path, dtype,
                                                            two_bw):
    ref = _jax_state(dtype, two_bw)
    save_checkpoint(str(tmp_path / "p"), convert.from_jax(ref, device="cpu"),
                    step=5, extra=_EXTRA)
    JC.save_checkpoint(str(tmp_path / "j"), ref, step=5, extra=_EXTRA)
    assert (tmp_path / "p.meta").read_bytes() == \
        (tmp_path / "j.meta").read_bytes()
    got = jax.tree.map(np.asarray, JC.restore_checkpoint(
        str(tmp_path / "p"), ref))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (k, a), (_, b) in zip(flat(got), flat(ref)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), k


def test_restore_lands_on_the_device_asked_for_in_the_saved_dtype(tmp_path):
    """bf16 stored as f32 comes back bf16 even with an f32 ``like``."""
    save_checkpoint(str(tmp_path / "c"), dict(
        w=torch.arange(8.).reshape(2, 4).to(torch.bfloat16),
        step=torch.tensor(3, dtype=torch.int32)))
    meta = checkpoint_meta(str(tmp_path / "c"))
    assert meta["dtypes"] == dict(step="int32", w="bfloat16")
    with CheckpointReader(str(tmp_path / "c")) as ck:
        assert ck.array("w").dtype == np.float32 and ck.shape("w") == (2, 4)
    got = restore_checkpoint(str(tmp_path / "c"), dict(
        w=torch.zeros(2, 4), step=torch.zeros((), dtype=torch.int32)),
        device="cpu")
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"].float(), torch.arange(8.).reshape(2, 4))


def test_reader_reads_rows_alone_and_checks_each_members_crc(tmp_path):
    """A stage's row of a stacked leaf is read alone; a flipped byte in a
    member fails its CRC on a whole read (the JAX package's ``np.load``
    reads the same file)."""
    w = torch.arange(24.).reshape(4, 3, 2)
    save_checkpoint(str(tmp_path / "c"), dict(w=w, b=torch.ones(3)))
    with CheckpointReader(str(tmp_path / "c")) as ck:
        assert ck.keys == ["b", "w"]
        for i in range(4):
            assert torch.equal(ck.leaf("w", row=i), w[i])
    with np.load(str(tmp_path / "c.npz")) as z:
        assert np.array_equal(z["w"], w.numpy())
    raw = bytearray((tmp_path / "c.npz").read_bytes())
    at = raw.index(np.float32(23.0).tobytes())
    raw[at] ^= 1
    (tmp_path / "c.npz").write_bytes(bytes(raw))
    with CheckpointReader(str(tmp_path / "c")) as ck:
        assert torch.equal(ck.leaf("b"), torch.ones(3))
        with pytest.raises(ValueError, match="member w fails its CRC"):
            ck.leaf("w")


def test_key_mismatch_names_keys(tmp_path):
    save_checkpoint(str(tmp_path / "c"), dict(a=torch.zeros(2),
                                              b=torch.zeros(2)))
    with pytest.raises(CheckpointMismatch) as e:
        restore_checkpoint(str(tmp_path / "c"), dict(a=torch.zeros(2),
                                                     c=torch.zeros(2)),
                           device="cpu")
    msg = str(e.value)
    assert "missing keys ['c']" in msg and "unexpected keys ['b']" in msg


def test_shape_mismatch_names_keys_and_suggests_reshard(tmp_path):
    save_checkpoint(str(tmp_path / "c"), dict(w=torch.zeros(4, 2, 8)))
    with pytest.raises(CheckpointMismatch) as e:
        restore_checkpoint(str(tmp_path / "c"), dict(w=torch.zeros(2, 4, 8)),
                           device="cpu")
    msg = str(e.value)
    assert "w: saved (4, 2, 8) != expected (2, 4, 8)" in msg
    assert "reshard it first?" in msg


# ---------------------------------------------------------------------------
# reshard against the JAX package's
# ---------------------------------------------------------------------------

LAYOUTS = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (3, 1), (8, 1)]


def _plan(stages, virtual, n_layers):
    lc = math.ceil(n_layers / (stages * virtual))
    return ST.StagePlan(n_stages=stages, tensor=1, layers_per_stage=lc,
                        n_layers_padded=stages * virtual * lc,
                        virtual=virtual)


def _jplan(p):
    return JST.StagePlan(**dataclasses.asdict(p))


def _layered(rng, plan, n_layers) -> dict:
    """A ``{params, opt}`` tree stacked for ``plan`` with distinct layer
    values (padded slots repeat the last layer), a bf16-marked leaf, the
    int32 step."""
    def stacked(*shape):
        a = rng.standard_normal((n_layers,) + shape).astype(np.float32)
        a = np.concatenate([a, np.repeat(a[-1:], plan.n_layers_padded
                                         - n_layers, 0)])
        return np.asarray(ST._stack_chunks(a, plan))
    layers = dict(attn=dict(wq=stacked(3, 2)), ln1=stacked(4))
    embed = rng.standard_normal((5, 3)).astype(np.float32)
    return dict(params=dict(layers=layers, embed=embed),
                opt=dict(m=dict(layers=layers, embed=embed),
                         step=np.asarray(9, np.int32)))


def _same_checkpoints(a: str, b: str):
    assert pathlib.Path(a + ".meta").read_bytes() == \
        pathlib.Path(b + ".meta").read_bytes()
    with np.load(a + ".npz") as x, np.load(b + ".npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("n_layers", [8, 12, 7])
def test_reshard_checkpoint_is_the_jax_packages(tmp_path, n_layers):
    rng = np.random.default_rng(n_layers)
    for (sa, va), (sb, vb) in itertools.product(LAYOUTS, LAYOUTS):
        pa, pb = _plan(sa, va, n_layers), _plan(sb, vb, n_layers)
        src, tag = str(tmp_path / "src"), f"{sa}{va}{sb}{vb}"
        JC.save_checkpoint(src, _layered(rng, pa, n_layers), step=9,
                           extra=dict(layout=layout_dict(pa, n_layers)))
        got = reshard_checkpoint(src, str(tmp_path / f"p{tag}"), pb)
        want = JC.reshard_checkpoint(src, str(tmp_path / f"j{tag}"),
                                     _jplan(pb))
        assert got == want
        _same_checkpoints(str(tmp_path / f"p{tag}"),
                          str(tmp_path / f"j{tag}"))


def test_reshard_tree_is_the_jax_packages():
    rng = np.random.default_rng(1)
    pa, pb = _plan(4, 1, 7), _plan(2, 2, 7)
    tree = _layered(rng, pa, 7)
    got = reshard_tree(tree, pa, pb, 7)
    want = jax.tree.map(np.asarray, JC.reshard_tree(tree, _jplan(pa),
                                                    _jplan(pb), 7))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a, b)
    t = reshard_tree(convert.from_jax(tree, device="cpu"), pa, pb, 7)
    for a, b in zip(ST.tree_leaves(t), jax.tree.leaves(want)):
        assert np.array_equal(a.numpy(), b)


def _refusal(case: str, tmp: pathlib.Path, pkg) -> None:
    """One of the reference's four refusals, through ``pkg`` (the port's
    checkpoint module or the JAX package's)."""
    rng = np.random.default_rng(2)
    plan = _plan if pkg is not JC else (lambda *a: _jplan(_plan(*a)))
    pa = _plan(4, 1, 8)
    tree = _layered(rng, pa, 8)
    src = str(tmp / "src")
    if case == "lead":              # claims an [8, 1, ...] stacking
        pkg.reshard_tree(tree, plan(8, 1, 8), plan(2, 2, 8), 8)
    elif case == "too small":
        pkg.reshard_tree(tree, plan(4, 1, 8), dataclasses.replace(
            plan(2, 1, 4), n_layers_padded=4), 8)
    elif case == "tensor":
        JC.save_checkpoint(src, tree,
                           extra=dict(layout=layout_dict(pa, 8)))
        pkg.reshard_checkpoint(src, str(tmp / "dst"), dataclasses.replace(
            plan(2, 2, 8), tensor=2))
    else:                           # no layout recorded
        JC.save_checkpoint(src, tree)
        pkg.reshard_checkpoint(src, str(tmp / "dst"), plan(2, 2, 8))


@pytest.mark.parametrize("case,match", [
    ("lead", "does not carry the source plan's stacking"),
    ("too small", "padded layers < 8 real layers"),
    ("tensor", "tensor degree change"),
    ("no layout", "records no layout")])
def test_reshard_refuses_as_the_jax_package_does(tmp_path, case, match):
    import repro_torch.checkpoint as TC
    with pytest.raises(JC.CheckpointMismatch, match=match):
        _refusal(case, tmp_path, JC)
    with pytest.raises(CheckpointMismatch, match=match):
        _refusal(case, tmp_path, TC)
    assert not (tmp_path / "dst.npz").exists()


# ---------------------------------------------------------------------------
# rank shares and the whole tree
# ---------------------------------------------------------------------------

def _share_of(state: dict, plan, s: int, t: int, cfg) -> dict:
    """Rank (s, t)'s share of ``state``: the leaves under the parameter
    tops its stage holds (``stage_share``'s: ``layers``; ``embed`` on
    the first stage and, tied, on the last; ``final_norm`` and ``head``
    on the last), each cut by ``cut_leaf``; the scalars as they are."""
    last = s == plan.n_stages - 1
    tops = {"layers"} | ({"final_norm", "head"} if last else set())
    if s == 0 or (last and "head" not in state["params"]):
        tops.add("embed")
    out = {}
    for p in ST.leaf_paths(state):
        pp = ST.param_path(p)
        if pp is not None and pp[0] not in tops:
            continue
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = ST.cut_leaf(p, ST._leaf_at(state, p), cfg, plan, s, t)
    return out


@pytest.mark.parametrize("S,T,tied", [(2, 1, True), (3, 2, True),
                                      (2, 2, False), (1, 4, True)])
def test_rank_shares_join_into_the_stacked_state(S, T, tied):
    """``stage.cut_leaf`` of every leaf of a training state (params, both
    moments, 2bw's ``pending``, the scalars) at every (stage, shard)
    gives ``stage_share`` + ``tensor_share``'s shares; ``join_shares``
    puts them back bit for bit (the embedding at ``padded_vocab(T)``
    rows) and ``joined_shape`` gives the whole shapes."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(
        n_layers=5, d_model=64), stages=S, tensor=T, tie_embeddings=tied,
        n_kv_heads=2)
    plan = ST.plan_stages(cfg)
    params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    state = dict(params=params, opt=dict(
        inner=dict(m=ST._map_layers(lambda a: a * 2, params),
                   v=ST._map_layers(lambda a: a * 3, params),
                   step=torch.tensor(4, dtype=torch.int32)),
        pending=ST._map_layers(lambda a: a + 1, params),
        primed=torch.tensor(True)))
    shares = [[_share_of(state, plan, s, t, cfg) for t in range(T)]
              for s in range(S)]
    for s, t in itertools.product(range(S), range(T)):
        want = ST.tensor_share(ST.stage_share(params, plan, s), cfg, plan, t)
        got = shares[s][t]["params"]
        assert ST.leaf_paths(got) == ST.leaf_paths(want)
        for a, b in zip(ST.tree_leaves(got), ST.tree_leaves(want)):
            assert torch.equal(a, b)
        for p in ST.leaf_paths(shares[s][t]):
            assert ST.joined_shape(p, ST._leaf_at(shares[s][t], p).shape,
                                   cfg, plan) == \
                tuple(ST._leaf_at(state, p).shape)
    whole = ST.join_shares(shares, cfg, plan)
    assert ST.leaf_paths(whole) == ST.leaf_paths(state)
    for a, b in zip(ST.tree_leaves(whole), ST.tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# import isolation
# ---------------------------------------------------------------------------

_ISOLATED = r"""
import sys
for name in ("jax", "msgpack", "ml_dtypes", "repro"):
    sys.modules[name] = None       # any import of these now raises
import os, tempfile, torch
import repro_torch.checkpoint as CK
import repro_torch.launch.train
d = tempfile.mkdtemp()
tree = dict(w=torch.randn(3, 4).to(torch.bfloat16),
            step=torch.tensor(7, dtype=torch.int32),
            primed=torch.tensor(True))
CK.save_checkpoint(os.path.join(d, "c"), tree, step=7, extra=dict(a=[1.5]))
back = CK.restore_checkpoint(os.path.join(d, "c"), tree, device="cpu")
assert all(torch.equal(back[k], tree[k]) and back[k].dtype == tree[k].dtype
           for k in tree)
assert CK.checkpoint_meta(os.path.join(d, "c"))["extra"] == dict(a=[1.5])
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "msgpack", "ml_dtypes", "repro") and sys.modules[m]]
assert not loaded, loaded
print("OK")
"""


def test_checkpoint_and_train_cli_import_no_jax_msgpack_or_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "OK"
