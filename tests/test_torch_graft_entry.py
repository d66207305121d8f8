"""roman_tpu_torch.graft_entry against __graft_entry__.py on the CPU: the
same example batch, and entry()'s registration equal to the reference's
under jax.jit, the jittable step it is (sel and count equal, T_align within
1e-4); without a device it raises on a host without a card;
dryrun_multichip is re-exported."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref
from roman_tpu_torch import graft_entry
from roman_tpu_torch.parallel import multichip

torch.set_num_threads(1)


def test_entry_matches_graft_entry_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    j_fn, j_args = ref.entry()
    assert len(args) == len(j_args) == 8
    for a, b in zip(args, j_args):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sel, count, T = fn(*args)
    j_sel, j_count, j_T = (np.asarray(x) for x in jax.jit(j_fn)(*j_args))
    assert sel.shape == (4, 16, 16) and T.shape == (4, 4, 4)
    np.testing.assert_array_equal(sel.numpy(), j_sel)
    np.testing.assert_array_equal(count.numpy(), j_count)
    assert (j_count >= 4).all()
    np.testing.assert_allclose(T.numpy(), j_T, rtol=0, atol=1e-4)


def test_entry_without_a_device_raises_on_a_host_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


def test_dryrun_multichip_is_re_exported():
    assert graft_entry.dryrun_multichip is multichip.dryrun_multichip
    assert set(graft_entry.__all__) == {"entry", "dryrun_multichip"}
