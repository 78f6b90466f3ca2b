"""The multi-device dry run (__graft_entry__.dryrun_multichip): every
sharded route against its unsharded result on simulated CPU devices, with
no environment forcing and no patched routing."""

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import __graft_entry__  # noqa: E402


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip(n, capsys):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} simulated devices")
    __graft_entry__.dryrun_multichip(n)
    assert f"dryrun_multichip({n}) ok" in capsys.readouterr().out


def test_entry_forward_step_runs():
    import numpy as np

    fn, args = __graft_entry__.entry()
    score, length = jax.jit(fn)(*args)
    assert np.asarray(score).shape == (4,)
    assert np.all(np.isfinite(np.asarray(score)))
    assert np.all(np.asarray(length) >= 63)
