"""The PyTorch WidebandReceiver against the JAX one, end to end.

Parameters are carried from the JAX receiver by ``from_numpy_params`` and
both take the JAX receiver's ``example_inputs`` (numpy), so they compute the
same thing. Best channel, shift, bin and symbols exact. QF^2 within rtol
1e-4 (f32 peak search on both sides, summed in different orders: see
test_torch_xcorr); per-channel energies within rtol 1e-5 (f32 channelizers,
see test_torch_wola).
"""

import numpy as np
import pytest
import torch

from pydsproutines_tpu.models import WidebandReceiver as JaxReceiver
from pydsproutines_tpu_torch import WidebandReceiver

CONFIGS = [
    # __graft_entry__.entry()'s geometry
    dict(num_channels=16, num_taps=128, template_len=256, num_shifts=128,
         osr=4, demod_syms=32),
    # the slice's channelizer geometry (64 ch, 2048 taps: B = 32)
    dict(num_channels=64, num_taps=2048, template_len=1024, num_shifts=256,
         osr=4, demod_syms=128),
]


@pytest.fixture(scope="module", params=CONFIGS,
                ids=["graft-16ch", "slice-64ch-2048taps"])
def pair(request):
    cfg = request.param
    jr = JaxReceiver(**cfg)
    t_ri, rx_ri = (np.array(a) for a in jr.example_inputs())
    tr = WidebandReceiver.from_numpy_params({"f_tap": np.asarray(jr.f_tap),
                                             **cfg}, device="cpu")
    return jr, tr, t_ri, rx_ri


def test_step_matches_jax(pair):
    jr, tr, t_ri, rx_ri = pair
    jq, js, jb, je, jsym = (np.asarray(a) for a in jr.step(t_ri, rx_ri))
    tq, ts, tb, te, tsym = tr.step(torch.from_numpy(t_ri),
                                   torch.from_numpy(rx_ri))
    assert int(ts) == int(js)
    assert int(tb) == int(jb)
    assert int(torch.argmax(te)) == int(np.argmax(je))
    assert tsym.dtype == torch.int32
    np.testing.assert_array_equal(tsym.numpy(), jsym)
    np.testing.assert_allclose(float(tq), float(jq), rtol=1e-4)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-5)


def test_run_summary_matches_jax(pair):
    jr, tr, t_ri, rx_ri = pair
    jsum = jr.run(t_ri, rx_ri)
    tsum = tr.run(torch.from_numpy(t_ri), torch.from_numpy(rx_ri))
    extra = {"wola_path", "wola_path_reason", "kernel_launches"}
    assert set(tsum) == set(jsum) | extra
    for key in ("best_shift", "freq_bin", "best_channel", "demod_syms",
                "config"):
        assert tsum[key] == jsum[key], key
    assert tsum["xcorr_path"] == "plain"            # CPU tensors
    assert tsum["kernel_launches"] == {"wola_fused": 0, "caf_peak": 0}


def test_example_inputs_match_jax():
    cfg = CONFIGS[0]
    j_t, j_rx = JaxReceiver(**cfg).example_inputs(seed=3)
    t_t, t_rx = WidebandReceiver(**cfg, device="cpu").example_inputs(seed=3)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(j_t))
    np.testing.assert_array_equal(t_rx.numpy(), np.asarray(j_rx))


def test_from_numpy_params_rejects_wrong_taps():
    with pytest.raises(ValueError):
        WidebandReceiver.from_numpy_params(
            {"f_tap": np.ones(100, np.float32), "num_channels": 16,
             "num_taps": 128}, device="cpu")
