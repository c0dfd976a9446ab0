"""Ratio-contract margin table: default/high vs zlib-6/9 at three sizes.

VERDICT r4 item 5: the contract (default <= zlib-6, high <= zlib-9 AND
zlib-6 on every corpus class) was only ever verified pass/fail at 128 KiB
caps.  This script REPORTS the margins (ours / oracle) per corpus at
128 KiB, 512 KiB and 1 MiB caps so headroom erosion is visible before a
contract test flips.

Corpus classes: the 7 round-4 pins plus the round-5 additions (sqlite_db =
/usr/share/proj/proj.db, tar_tree = tarfile of the numpy package tree —
mixed text/binary with 512-byte-aligned headers, the class that exposed
the r4 default-contract hole).

Usage: python scripts/contract_margins.py [--sizes 128,512,1024] [--preset default,high]
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import sys
import tarfile
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import deflate_rs_tpu as dt  # noqa: E402
from deflate_rs_tpu import CompressionOptions  # noqa: E402


def corpora(cap: int) -> dict:
    out = {}
    for nm, path in (
        ("libc_elf", "/usr/lib/x86_64-linux-gnu/libc.so.6"),
        ("bash_elf", "/bin/bash"),
        ("sqlite_db", "/usr/share/proj/proj.db"),
    ):
        if os.path.exists(path):
            out[nm] = open(path, "rb").read()[:cap]
    docs = []
    for p in sorted(glob.glob("/usr/share/doc/*/copyright"))[:2000]:
        try:
            docs.append(open(p, "rb").read())
        except OSError:
            continue
        if sum(map(len, docs)) > cap:
            break
    out["doc_text"] = b"".join(docs)[:cap]
    js = []
    for p in sorted(glob.glob("/usr/share/gdal/*.json"))[:400]:
        js.append(open(p, "rb").read())
        if sum(map(len, js)) > cap:
            break
    out["json_cfg"] = b"".join(js)[:cap]
    py = []
    npdir = os.path.dirname(np.__file__)
    for p in sorted(glob.glob(os.path.join(npdir, "**", "*.py"), recursive=True)):
        py.append(open(p, "rb").read())
        if sum(map(len, py)) > cap:
            break
    out["py_source"] = b"".join(py)[:cap]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pg = open(os.path.join(here, "tests", "data", "pg11.txt"), "rb").read()
    out["pg11"] = (pg * (cap // len(pg) + 1))[:cap]
    out["issue18"] = open(
        os.path.join(here, "tests", "data", "issue_18_201911.bin"), "rb"
    ).read()[:cap]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as t:
        total = 0
        for p in sorted(glob.glob(os.path.join(npdir, "**", "*"), recursive=True)):
            if os.path.isfile(p):
                t.add(p, arcname=os.path.relpath(p, npdir))
                total += os.path.getsize(p)
            if total > cap:
                break
    out["tar_tree"] = buf.getvalue()[:cap]
    etc = []
    for p in sorted(q for q in glob.glob("/etc/**/*", recursive=True)
                    if os.path.isfile(q) and os.access(q, os.R_OK))[:4000]:
        try:
            etc.append(open(p, "rb").read())
        except OSError:
            continue
        if sum(map(len, etc)) > cap:
            break
    if sum(map(len, etc)) >= 32 * 1024:
        out["etc_text"] = b"".join(etc)[:cap]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="128,512,1024")
    ap.add_argument("--presets", default="default,high")
    args = ap.parse_args()
    sizes = [int(s) << 10 for s in args.sizes.split(",")]
    presets = args.presets.split(",")

    opts = {"default": CompressionOptions.default(), "high": CompressionOptions.high()}
    worst = {}
    for cap in sizes:
        corp = corpora(cap)
        for preset in presets:
            for nm in sorted(corp):
                data = corp[nm]
                z6 = len(zlib.compress(data, 6)) - 6
                z9 = len(zlib.compress(data, 9)) - 6
                t0 = time.time()
                ours = len(dt.deflate_bytes_conf(data, opts[preset]))
                dt_s = time.time() - t0
                if preset == "default":
                    m = ours / z6
                    tag = f"vs z6 {m:.4f}"
                else:
                    m = max(ours / z9, ours / z6)
                    tag = f"vs z9 {ours / z9:.4f} z6 {ours / z6:.4f}"
                key = (preset, nm)
                worst[key] = max(worst.get(key, 0.0), m)
                print(
                    f"{cap >> 10:5d}K {preset:7s} {nm:10s} n={len(data):8d} "
                    f"ours={ours:8d} {tag}  ({dt_s:.0f}s)",
                    flush=True,
                )
    print("\nworst margin per (preset, corpus) over all sizes:")
    bad = 0
    for (preset, nm), m in sorted(worst.items()):
        flag = "  <-- OVER" if m > 1.0 else ""
        bad += m > 1.0
        print(f"  {preset:7s} {nm:10s} {m:.4f}{flag}")
    print(f"{'CONTRACT HOLDS at all sizes' if not bad else f'{bad} OVER-1.0 margins'}")


if __name__ == "__main__":
    main()
