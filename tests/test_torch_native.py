"""The port's native loader (`qcss_tpu_torch.native`) against the JAX
package's.

* the four C++ sources are byte-for-byte copies of `qcss_tpu/native/`;
* the loader builds them with g++ into the checkout's build directory and
  binds every entry point;
* the syndrome tables, the GF(2) row reduction and the OSD decoders of the
  two libraries agree exactly on shared inputs.
"""

from pathlib import Path

import numpy as np
import pytest

from qcss_tpu import native as jnative
from qcss_tpu.codes import families as jfam
from qcss_tpu.ops import gf2 as jgf2
from qcss_tpu_torch import native as tnative
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.ops import gf2 as tgf2

ROOT = Path(__file__).resolve().parent.parent
SYMBOLS = ("qcss_syndrome_table", "qcss_rref", "qcss_uf_decode_batch",
           "qcss_mwpm_create", "qcss_mwpm_destroy", "qcss_mwpm_decode_batch",
           "qcss_osd0_batch", "qcss_osde_batch")


@pytest.mark.parametrize("name", tnative.SOURCES)
def test_sources_are_byte_copies(name):
    assert (ROOT / "qcss_tpu_torch" / "native" / name).read_bytes() == (
        ROOT / "qcss_tpu" / "native" / name).read_bytes()


def test_loader_builds_and_binds_every_symbol():
    assert tnative.available(), tnative.load_error
    path = tnative.library_path()
    assert path.exists() and path.name == "libqcss.so"
    assert path.parent.parent == tnative._build_root()
    lib = tnative._try_load()
    for sym in SYMBOLS:
        assert getattr(lib, sym).argtypes, sym


def test_cache_override(monkeypatch, tmp_path):
    monkeypatch.setenv("QCSS_NATIVE_CACHE", str(tmp_path))
    assert tnative.library_path().parent.parent == tmp_path
    monkeypatch.delenv("QCSS_NATIVE_CACHE")
    assert tnative._build_root() == ROOT / "build" / "native"


def test_library_path_follows_the_host_cpu(monkeypatch):
    """A build for another CPU (`-march=native` resolved otherwise) lands
    in another directory, so it is never loaded here."""
    here = tnative.library_path()
    assert "-march=" in tnative._host_target()
    monkeypatch.setattr(tnative, "_host_target", lambda: "-march= other")
    assert tnative.library_path() != here


CODES = {"steane": "steane", "golay": "golay", "surface5": "rotated_surface"}


@pytest.mark.parametrize("name", list(CODES))
def test_syndrome_tables_equal(name):
    args = (5,) if name == "surface5" else ()
    cj = getattr(jfam, CODES[name])(*args)
    ct = getattr(tfam, CODES[name])(*args)
    for attr in ("parity_check_c1", "parity_check_c2"):
        h = getattr(ct, attr)
        np.testing.assert_array_equal(h, getattr(cj, attr))
        for limit, stop in ((2, True), (3, False)):
            got = tnative.syndrome_table_native(h, limit, stop)
            want = jnative.syndrome_table_native(h, limit, stop)
            assert got[0] == want[0] and got[1] == want[1]
            np.testing.assert_array_equal(got[2], want[2])
        t_t, tab_t = tgf2.syndrome_table(h)
        t_j, tab_j = jgf2.syndrome_table(h)
        assert t_t == t_j and list(tab_t) == list(tab_j)
        for k in tab_j:
            np.testing.assert_array_equal(tab_t[k], tab_j[k])


def test_rref_and_osd_equal():
    rng = np.random.default_rng(4)
    h = (rng.random((12, 30)) < 0.3).astype(np.uint8)
    got, want = tnative.rref_native(h), jnative.rref_native(h)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    synd = (rng.random((64, 12)) < 0.5).astype(np.uint8)
    soft = rng.normal(size=(64, 30)).astype(np.float32)
    np.testing.assert_array_equal(tnative.osd0_batch_native(h, synd, soft),
                                  jnative.osd0_batch_native(h, synd, soft))
    np.testing.assert_array_equal(
        tnative.osde_batch_native(h, synd, soft, 2, 6, 4),
        jnative.osde_batch_native(h, synd, soft, 2, 6, 4))


def test_entry_points_fall_back_without_the_library(monkeypatch):
    monkeypatch.setattr(tnative, "_try_load", lambda: None)
    h = tfam.steane().parity_check_c2
    assert not tnative.available()
    assert tnative.syndrome_table_native(h, 2, True) is None
    assert tnative.rref_native(h) is None
    t_t, tab_t = tgf2.syndrome_table(h)  # the Python enumerator
    t_j, tab_j = jgf2.syndrome_table(h)
    assert t_t == t_j and list(tab_t) == list(tab_j)
