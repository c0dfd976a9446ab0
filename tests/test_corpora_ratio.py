"""Diverse-corpora ratio guards (VERDICT r2 item 7).

The high preset is the ratio flagship: it must stay at-or-under BOTH zlib-9
and zlib-6 on every in-image corpus class (ELF code, concatenated docs, JSON
configs, Python sources, text, structured binary).  The default preset must
stay at-or-under zlib-6 on EVERY corpus — the round-3 throughput tiering
(1.40x json allowance) is gone: the budgeted long-range pass
(ops/longrange.py) closes the cross-file corpora (VERDICT r3 item 1).
"""

import glob
import os
import zlib

import pytest

import deflate_rs_tpu as dt
from deflate_rs_tpu import CompressionOptions

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
CAP = 128 * 1024


def _corpora():
    out = {}
    for name, path in (
        ("libc_elf", "/usr/lib/x86_64-linux-gnu/libc.so.6"),
        ("bash_elf", "/bin/bash"),
    ):
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = f.read()[:CAP]
    docs = []
    for p in sorted(glob.glob("/usr/share/doc/*/copyright"))[:200]:
        try:
            with open(p, "rb") as f:
                docs.append(f.read())
        except OSError:
            continue
        if sum(map(len, docs)) > CAP:
            break
    if docs:
        out["doc_text"] = b"".join(docs)[:CAP]
    js = []
    for p in sorted(glob.glob("/usr/share/gdal/*.json"))[:50]:
        with open(p, "rb") as f:
            js.append(f.read())
        if sum(map(len, js)) > CAP:
            break
    if js:
        out["json_cfg"] = b"".join(js)[:CAP]
    import numpy as _np

    py = []
    npdir = os.path.dirname(_np.__file__)
    for p in sorted(glob.glob(os.path.join(npdir, "**", "*.py"), recursive=True))[:80]:
        with open(p, "rb") as f:
            py.append(f.read())
        if sum(map(len, py)) > CAP:
            break
    out["py_source"] = b"".join(py)[:CAP]
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        out["pg11"] = f.read()[:CAP]
    with open(os.path.join(DATA_DIR, "issue_18_201911.bin"), "rb") as f:
        out["issue18"] = f.read()
    # Round-5 classes (VERDICT r4 item 5): an sqlite database file and a
    # tar of a mixed source tree (512-byte-aligned headers over text +
    # binary — the class that exposed the r4 default-contract hole at
    # 1.0017 of zlib-6, closed by the S=64/stride-1 LR budget).
    if os.path.exists("/usr/share/proj/proj.db"):
        with open("/usr/share/proj/proj.db", "rb") as f:
            out["sqlite_db"] = f.read()[:CAP]
    import io
    import tarfile

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as t:
        total = 0
        for p in sorted(glob.glob(os.path.join(npdir, "**", "*"), recursive=True)):
            if os.path.isfile(p):
                t.add(p, arcname=os.path.relpath(p, npdir))
                total += os.path.getsize(p)
            if total > CAP:
                break
    out["tar_tree"] = buf.getvalue()[:CAP]
    # Round-5 (final session) class: concatenated /etc config text — many
    # short files of mixed prose/structured config (scripts/probes/
    # new_corpora_r5.py measured default 0.9833 / high 0.9817 of zlib-6).
    etc = []
    for p in sorted(q for q in glob.glob("/etc/**/*", recursive=True)
                    if os.path.isfile(q) and os.access(q, os.R_OK))[:400]:
        try:
            with open(p, "rb") as f:
                etc.append(f.read())
        except OSError:
            continue
        if sum(map(len, etc)) > CAP:
            break
    if sum(map(len, etc)) >= 32 * 1024:
        out["etc_text"] = b"".join(etc)[:CAP]
    return out


CORPORA = _corpora()


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_high_beats_zlib9_and_zlib6(name):
    data = CORPORA[name]
    ours = len(dt.deflate_bytes_conf(data, CompressionOptions.high()))
    z9 = len(zlib.compress(data, 9)) - 6
    z6 = len(zlib.compress(data, 6)) - 6
    assert ours <= z9, f"high {ours} > zlib-9 {z9} on {name}"
    assert ours <= z6, f"high {ours} > zlib-6 {z6} on {name}"


# The BASELINE "size <= per level" contract, untiered: default holds
# zlib-6 on every corpus class (the r3 1.40x/1.06x/1.02x allowances are
# dead — VERDICT r3 item 1).
DEFAULT_CEILING = {name: 1.0 for name in (
    "libc_elf", "bash_elf", "pg11", "issue18", "doc_text", "py_source",
    "json_cfg", "sqlite_db", "tar_tree", "etc_text",
)}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_default_beats_zlib6(name):
    data = CORPORA[name]
    ours = len(dt.deflate_bytes_conf(data, CompressionOptions.default()))
    z6 = len(zlib.compress(data, 6)) - 6
    assert ours <= z6 * DEFAULT_CEILING[name], (
        f"default {ours} > zlib-6 {z6} on {name}"
    )


# Fast regression ceilings: absolute sizes measured at the round-4 config
# (greedy K=1, PW=4, nk=1, nq=1, no long-range — scripts/probes/
# fast_ratio_sweep.py).  Fast's external contract is the reference's fast
# (1 greedy hash check, compression_options.rs:141-148), which no in-image
# oracle reproduces, so these pins only stop silent regressions; tighten on
# improvement.  The absolute pin applies only while the corpus bytes match
# the recorded content hash (most corpora are environment-derived files —
# a base-image update must not falsely fail the pin, ADVICE r4); on a hash
# mismatch the guard falls back to a relative ceiling vs zlib-1 on the
# same bytes, at the margin measured on the pinned content plus 1%.
FAST_CEILING = {
    "bash_elf": (57541, "eed5d7673ad1ee24"),
    "doc_text": (43559, "b2b4d09a8af50bbc"),
    "issue18": (33097, "1d038749034dab1a"),
    "json_cfg": (12595, "72317e4e3e876043"),
    "libc_elf": (62340, "c938ec636e78e5a3"),
    "pg11": (54125, "08dd854305253962"),
    "py_source": (43070, "64b624f6669ab4d7"),
    "sqlite_db": (20538, "7796eebcdc29ffb5"),
    "tar_tree": (36004, "0c887f33adc313fd"),
    "etc_text": (62654, "9eef37032e73dd5a"),
}
# fast / zlib-1 margins on the pinned content (pin / (z1 - 6)):
FAST_REL_MARGIN = {
    "bash_elf": 1.0033, "doc_text": 1.0478, "issue18": 0.9862,
    "json_cfg": 1.7564, "libc_elf": 0.9923, "pg11": 0.9488,
    "py_source": 0.9938, "sqlite_db": 1.0279, "tar_tree": 0.9850,
    "etc_text": 1.0082,
}


@pytest.mark.parametrize("name", sorted(FAST_CEILING))
def test_fast_regression_ceiling(name):
    if name not in CORPORA:
        pytest.skip(f"{name} not in image")
    import hashlib
    import zlib as _z

    data = CORPORA[name]
    ours = len(dt.deflate_bytes_conf(data, CompressionOptions.fast()))
    pin, sha = FAST_CEILING[name]
    if hashlib.sha256(data).hexdigest()[:16] == sha:
        assert ours <= pin, f"fast {ours} > pinned {pin} on {name}"
    else:
        z1 = len(_z.compress(data, 1)) - 6
        ceil = z1 * FAST_REL_MARGIN[name] * 1.01
        assert ours <= ceil, (
            f"fast {ours} > relative ceiling {ceil:.0f} (zlib-1 {z1}) on "
            f"{name} (content changed; absolute pin skipped)"
        )


# ---------------------------------------------------------------------------
# Large-input margin guards (VERDICT r4 item 5: the contract was only ever
# verified at 128 KiB caps; the round-5 margin table found size-scaling
# breaks).  512 KiB versions of the classes that were thinnest:
#   - default broke on tar_tree@512K (1.0010) and doc_text@1M (1.0004) at
#     M=32 dominants; M=48 closes both (and every 128 KiB margin widened).
#   - high/py_source at >= 512 KiB is a KNOWN measured gap vs zlib-9
#     (1.0007 of z9 at the round-5 config; z6 margin fine at 0.9958): LR
#     knobs measured no-op, K-depth saturates (+6 B over at K=512 for 2x
#     probe cost), schedule retuning recovered -36 B.  Pinned RELATIVE as a
#     regression ceiling, not claimed as contract-met.
# ---------------------------------------------------------------------------

def _corpus_512k(name: str) -> bytes:
    import io
    import tarfile

    cap = 512 * 1024
    if name == "tar_tree":
        import numpy as _np

        npdir = os.path.dirname(_np.__file__)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as t:
            total = 0
            for p in sorted(glob.glob(os.path.join(npdir, "**", "*"), recursive=True)):
                if os.path.isfile(p):
                    t.add(p, arcname=os.path.relpath(p, npdir))
                    total += os.path.getsize(p)
                if total > cap:
                    break
        return buf.getvalue()[:cap]
    if name == "doc_text":
        docs = []
        for p in sorted(glob.glob("/usr/share/doc/*/copyright"))[:2000]:
            try:
                docs.append(open(p, "rb").read())
            except OSError:
                continue
            if sum(map(len, docs)) > cap:
                break
        return b"".join(docs)[:cap]
    assert name == "py_source"
    import numpy as _np

    npdir = os.path.dirname(_np.__file__)
    py = []
    for p in sorted(glob.glob(os.path.join(npdir, "**", "*.py"), recursive=True)):
        py.append(open(p, "rb").read())
        if sum(map(len, py)) > cap:
            break
    return b"".join(py)[:cap]


@pytest.mark.parametrize("name", ["tar_tree", "doc_text", "py_source"])
def test_default_beats_zlib6_at_512k(name):
    data = _corpus_512k(name)
    ours = len(dt.deflate_bytes_conf(data, CompressionOptions.default()))
    z6 = len(zlib.compress(data, 6)) - 6
    assert ours <= z6, f"default {ours} > zlib-6 {z6} on {name}@512K"


def test_high_py_source_512k_known_gap_pinned():
    data = _corpus_512k("py_source")
    ours = len(dt.deflate_bytes_conf(data, CompressionOptions.high()))
    z9 = len(zlib.compress(data, 9)) - 6
    z6 = len(zlib.compress(data, 6)) - 6
    assert ours <= z6, "high must still beat zlib-6 at 512K"
    # Known gap vs z9: 1.0007 measured at the r5 config; guard regression
    # at +0.05% headroom without claiming the contract holds here.
    assert ours <= z9 * 1.0012, (
        f"high {ours} regressed past the pinned known-gap ceiling "
        f"(z9 {z9}, measured 1.0007)"
    )
