"""Constant tables and configuration of the PyTorch port against the JAX
reference, and the port's independence from JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu264.config import EncoderConfig as RefConfig
from tpu264.coding.intra_frame import CQP_J, lambda_terms_j
from tpu264.entropy import cabac_binarize as rcb
from tpu264.entropy import cabac_ctx as rctx
from tpu264.entropy import cabac_pallas as rpal
from tpu264.entropy import cabac_tables as rtbl
from tpu264.entropy import cavlc as rcavlc
from tpu264.entropy import cavlc_tables as rvlc
from tpu264.entropy import mb_syntax as rmbs
from tpu264.entropy import slice_writer as rsw
from tpu264.coding import inter_frame as rinter
from tpu264.kernels import interp as rkint
from tpu264.kernels import me as rkme
from tpu264.ref import interp as rri
from tpu264.kernels import deblock as rkd
from tpu264.kernels import intra as rki
from tpu264.kernels import transform as rkt

from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.config import EncoderConfig
from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_ctx as tctx
from tpu264_torch.entropy import cabac_engine_cuda as tk1
from tpu264_torch.entropy import cabac_tables as ttbl
from tpu264_torch.entropy import cavlc as tcavlc
from tpu264_torch.entropy import cavlc_tables as tvlc
from tpu264_torch.entropy import device_cavlc as tdc
from tpu264_torch.entropy import mb_syntax as tmbs
from tpu264_torch.entropy import slice_writer as tsw
from tpu264_torch.coding import inter_frame as tinter
from tpu264_torch.kernels import interp as tkint
from tpu264_torch.kernels import me as tkme
from tpu264_torch.ref import interp as tri
from tpu264_torch.kernels import deblock as tkd
from tpu264_torch.kernels import intra as tki
from tpu264_torch.kernels import transform as tkt
from tpu264_torch.ref.transform import chroma_qp

from torch_util import assert_equal, t32

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["MF_TABLE", "V_TABLE", "LIMIT_AC",
                                  "LIMIT_DC", "LIMIT_CDC", "ZIGZAG_4x4"])
def test_transform_tables(name):
    assert_equal(getattr(tkt, name), getattr(rkt, name), name)


def test_dc_scale_tables():
    assert_equal(tkt.MF00, rkt.MF00)
    assert_equal(tkt.V00, rkt.V00)


def _impulses(n):
    eye = np.eye(n * n, dtype=np.int64).reshape(n * n, n, n)
    return eye


@pytest.mark.parametrize("which", ["CF", "H4", "H2"])
def test_butterflies_equal_reference_matrices(which):
    """The port's butterflies compute M X M^T for the reference matrix M
    (checked on every impulse, which pins down the whole matrix)."""
    if which == "H2":
        x = _impulses(2)
        got = tkt.hadamard2x2(t32(x))
        m = np.asarray(rkt.H2)
    else:
        x = _impulses(4)
        got = tkt.fdct4x4(t32(x)) if which == "CF" else tkt.hadamard4x4(t32(x))
        m = np.asarray(rkt.CF if which == "CF" else rkt.H4)
    want = np.einsum("ij,njk,lk->nil", m, x, m)
    assert_equal(got, want, which)


def test_deblock_tables():
    assert_equal(tkd.ALPHA, rkd.ALPHA)
    assert_equal(tkd.BETA, rkd.BETA)
    assert_equal(np.asarray(tkd.TC0), rkd.TC0)


@pytest.mark.parametrize("name", ["RANGE_TAB_LPS", "TRANS_IDX_LPS",
                                  "TRANS_IDX_MPS", "INIT_TABLES"])
def test_cabac_tables(name):
    assert_equal(getattr(ttbl, name), getattr(rtbl, name), name)


def test_engine_tables_and_init():
    assert_equal(tk1._RANGE_LPS, rpal._RANGE_LPS)
    assert_equal(tk1._TRANS_MPS, rpal._TRANS_MPS)
    assert_equal(tk1._TRANS_LPS, rpal._TRANS_LPS)
    for table in range(4):
        for qp in range(52):
            assert_equal(tk1.init_packed_states(table, qp),
                         rpal.init_packed_states(table, qp))


def test_cabac_ctx_offsets_and_kinds():
    for name in ("SIG_CAT_OFF", "LVL_CAT_OFF", "CBF_CAT_OFF", "K_SKIP",
                 "K_INTER", "K_I4", "K_I16", "K_DIRECT", "I_REST"):
        assert getattr(tctx, name) == getattr(rctx, name), name
    assert (tcb.K_CTX, tcb.K_BYP, tcb.K_TERM) == \
        (rcb.K_CTX, rcb.K_BYP, rcb.K_TERM)


def test_chroma_qp():
    assert_equal([chroma_qp(q) for q in range(52)], CQP_J)


def test_lambda_table_matches_reference_float32():
    """The port's integer (lam4, lam24, lam_me) equals the reference's
    float32 computation at every QP."""
    want = [tuple(int(v) for v in lambda_terms_j(q)) for q in range(52)]
    assert list(tif.LAMBDA_TABLE) == want


@pytest.mark.parametrize("name", [
    "COEFF_TOKEN_BITS", "COEFF_TOKEN_LEN", "CDC_COEFF_TOKEN_BITS",
    "CDC_COEFF_TOKEN_LEN", "TOTAL_ZEROS_BITS", "TOTAL_ZEROS_LEN",
    "CDC_TOTAL_ZEROS_BITS", "CDC_TOTAL_ZEROS_LEN", "RUN_BEFORE_BITS",
    "RUN_BEFORE_LEN"])
def test_cavlc_tables(name):
    assert_equal(getattr(tvlc, name), getattr(rvlc, name), name)


@pytest.mark.parametrize("name", [
    "CODENUM_TO_CBP_INTRA", "CODENUM_TO_CBP_INTER", "CBP_TO_CODENUM_INTRA",
    "CBP_TO_CODENUM_INTER"])
def test_mb_syntax_tables(name):
    assert_equal(getattr(tmbs, name), getattr(rmbs, name), name)


def test_cavlc_slot_layout():
    assert tcavlc.SLOTS_PER_BLOCK == rcavlc.SLOTS_PER_BLOCK
    for name in ("HDR_SLOTS", "HDR_SLOTS_P", "MB_SLOTS", "MB_SLOTS_P",
                 "RES_BLOCKS"):
        assert getattr(tsw, name) == getattr(rsw, name), name
        assert getattr(tdc, name) == getattr(rsw, name), name


def test_trailing_skip_run_matches_reference():
    rng = np.random.default_rng(3)
    for p in (0.0, 0.5, 1.0):
        skipped = rng.random(99) < p
        for first, last in ((0, 99), (0, 33), (33, 66), (66, 99)):
            assert tsw.trailing_skip_run(skipped, first, last) == \
                rsw.trailing_skip_run(skipped, first, last)


def test_interp_tables():
    assert_equal(tri.TAPS, rri.TAPS)
    assert tri.QPEL_TABLE == rri.QPEL_TABLE
    assert_equal(tkint.TAPS, rkint.TAPS)
    assert_equal(tkint.QPEL_TABLE, rkint.QPEL_TABLE)
    assert tinter.PAD == rinter.PAD


@pytest.mark.parametrize("max_abs", [16, 4 * 24 + 3])
def test_mv_bits_table_matches_reference(max_abs):
    assert_equal(tkme.mv_bits_table(max_abs), rkme.mv_bits_table(max_abs))


def test_mvd_bits_matches_reference_over_the_mv_range():
    """The port's exact integer bit length against the reference's
    float32 log2, over every mv difference a +-(4 * 24 + 3) quarter-pel
    vector and its predictor can give."""
    import jax.numpy as jnp
    m = 2 * (4 * 24 + 3)
    v = np.arange(-m, m + 1)
    mvd = np.stack([np.repeat(v, 5), np.tile(v[::len(v) // 4][:5],
                                             len(v))], axis=1)
    want = rinter.mvd_bits(jnp.asarray(mvd, jnp.int32))
    assert_equal(tinter.mvd_bits(t32(mvd)), want)
    assert_equal(tkme.mv_cost(t32(mvd)), want)


def test_intra_taps_rebuild_reference_weights():
    w = np.zeros((128, 13), np.int64)
    for o in range(128):
        for k in range(3):
            w[o, tki._TAP_IDX[o, k]] += tki._TAP_W[o, k]
    assert_equal(w.T, rki.W4)
    assert_equal(tki.NEEDS4, rki.NEEDS4)


@pytest.mark.parametrize("kwargs", [
    {},
    dict(width=1280, height=720, qp=28, symbol_mode="CABAC", deblock=True),
    dict(width=352, height=288, qp=33, symbol_mode="CABAC", deblock=False,
         slices_per_frame=3, use_pallas=True, intra_period=1),
])
def test_from_reference_round_trips(kwargs):
    ref = RefConfig(**kwargs)
    port = EncoderConfig.from_reference(dataclasses.asdict(ref))
    want = {k: v for k, v in dataclasses.asdict(ref).items()
            if k != "use_pallas"}
    assert dataclasses.asdict(port) == want
    assert port.width_mbs == ref.width_mbs
    assert port.height_mbs == ref.height_mbs


def test_from_reference_rejects_unknown_fields():
    d = dataclasses.asdict(RefConfig())
    d["no_such_field"] = 1
    with pytest.raises(ValueError):
        EncoderConfig.from_reference(d)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu264_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "tpu264_torch.__path__, 'tpu264_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tpu264' or m.startswith('tpu264.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 40
    # the entry points of runtime/dryrun.py and the tools are walked too
    assert {"tpu264_torch.runtime.dryrun", "tpu264_torch.tools.card",
            "tpu264_torch.tools.rd_harness", "tpu264_torch.tools.x264_lavc",
            "tpu264_torch.tools.scaling_artifact",
            "tpu264_torch.tools.profile_frame"} <= mods


def imported_roots(path) -> set:
    """The top-level names of every absolute import in a source file, at
    module level or inside a function, including `importlib.import_module`
    and `__import__` calls with a literal name."""
    import ast
    roots = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots.add((node.module or "").split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def test_port_sources_import_no_jax():
    """No source file of `tpu264_torch/` names jax or the JAX package in an
    import, lazy ones inside functions included (the decoder imports
    inside functions)."""
    files = sorted((ROOT / "tpu264_torch").rglob("*.py"))
    assert len(files) >= 60
    bad = {str(f.relative_to(ROOT)): sorted(r & {"jax", "jaxlib", "tpu264"})
           for f in files if (r := imported_roots(f)) & {"jax", "jaxlib",
                                                         "tpu264"}}
    assert not bad, bad
    assert "tpu264_torch" in imported_roots(
        ROOT / "tpu264_torch" / "decode" / "decoder.py")
    scanned = {str(f.relative_to(ROOT)) for f in files}
    assert {"tpu264_torch/runtime/dryrun.py",
            "tpu264_torch/tools/rd_harness.py",
            "tpu264_torch/tools/scaling_artifact.py",
            "tpu264_torch/tools/x264_lavc.py"} <= scanned


def test_chip_smoke_imports_no_jax():
    """`chip_smoke.py` runs where jax is not installed: no import in it,
    at the top or inside a function, names jax or the JAX package."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "tpu264_torch" in roots
    assert not roots & {"jax", "jaxlib", "tpu264"}, sorted(names)


def test_tables_are_int32_torch():
    for t in (tkt.MF_TABLE, tkt.V_TABLE, tkt.LIMIT_AC, tki.TAP_W):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
