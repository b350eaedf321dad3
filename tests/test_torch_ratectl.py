"""The port's copy of the JVT-G012 rate controller
(`tpu264_torch.runtime.ratectl`) against the reference's
(`tpu264.runtime.ratectl`) on scripted sequences of (frame type, bits,
MAD), with no encoder: every QP and the whole state after every update
are equal, not only close (host float math, the same operations in the
same order)."""

import numpy as np
import pytest

from tpu264.runtime import ratectl as rrc

from tpu264_torch.runtime import ratectl as trc


def _script(seed, n=40):
    """(type, num_b, bits, mad) per frame: an IDR every 12 frames, P
    frames, and B frames riding on the anchors in the hierarchical case;
    bits and MAD drift, with scene-change jumps."""
    r = np.random.default_rng(seed)
    num_b = int(seed % 3)
    out = []
    for i in range(n):
        kind = "I" if i % 12 == 0 else ("B" if num_b and i % (num_b + 1)
                                        else "P")
        scale = 3.0 if kind == "I" else (0.4 if kind == "B" else 1.0)
        jump = 4.0 if r.random() < 0.1 else 1.0
        bits = int(scale * jump * r.integers(2_000, 60_000))
        mad = float(r.uniform(0.5, 12.0) * jump)
        out.append((kind, num_b if kind != "B" else 0, bits, mad))
    return out


@pytest.mark.parametrize("bitrate,init_qp,seed", [
    (100_000, 30, 0), (1_000_000, 28, 1), (8_000_000, 22, 2),
    (500_000, 40, 3), (50_000, 12, 4)])
def test_rate_controller_equals_reference(bitrate, init_qp, seed):
    kw = dict(bitrate=bitrate, frame_rate=30.0, n_mbs=396, init_qp=init_qp)
    ref, port = rrc.RateController(**kw), trc.RateController(**kw)
    qps = []
    for kind, num_b, bits, mad in _script(seed):
        if kind != "B":
            q = port.frame_qp(kind, num_b)
            assert q == ref.frame_qp(kind, num_b)
            qps.append(q)
        ref.update(kind, bits, mad)
        port.update(kind, bits, mad)
        assert port.get_state() == ref.get_state()
    assert len(set(qps)) >= 3
    # a checkpointed state resumes identically
    resumed = trc.RateController(**kw)
    resumed.set_state(port.get_state())
    assert resumed.frame_qp("P") == ref.frame_qp("P")


def test_qstep_conversions_equal_reference():
    qs = np.linspace(0, 51, 511)
    assert [trc.qp_to_qstep(q) for q in qs] == \
        [rrc.qp_to_qstep(q) for q in qs]
    steps = [trc.qp_to_qstep(q) for q in qs] + [0.0, 1e-9, 1e6]
    assert [trc.qstep_to_qp(s) for s in steps] == \
        [rrc.qstep_to_qp(s) for s in steps]
