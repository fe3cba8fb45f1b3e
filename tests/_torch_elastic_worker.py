"""The rank side of ``tests/test_torch_elastic.py``: ``launch.train.main``
runs with ``--ckpt`` / ``--resume`` / ``--die-at`` on spawned gloo ranks.
Every spawned rank imports this module, so it imports neither JAX nor
the JAX package.

A case is ``(name, argv)``; ``{dir}`` in an argument is the test's
temporary directory.  Each rank returns, by case name, what the CLI
returned (its losses, its start step and this rank's share of the
trained state, on the CPU), or the exit status of a ``SystemExit``
(``--die-at``), or the type and message of a ``CheckpointMismatch``;
every rank of the world runs the same cases in the same order.
"""
import contextlib
import io

import torch

from repro_torch.checkpoint import CheckpointMismatch
from repro_torch.launch import train


def run_cases(mesh, cases: list, tmp: str) -> dict:
    torch.set_num_threads(1)
    out = {}
    for name, argv in cases:
        argv = [a.replace("{dir}", tmp) for a in argv]
        try:
            with contextlib.redirect_stdout(io.StringIO()) as text:
                res = train.main(argv, mesh=mesh)
        except SystemExit as e:
            out[name] = dict(exit=e.code)
            continue
        except CheckpointMismatch as e:
            out[name] = dict(error=str(e))
            continue
        out[name] = dict(losses=res["losses"], start=res["start"],
                         state=dict(params=res["params"],
                                    opt=res["opt_state"]),
                         stdout=text.getvalue())
    return out
