#!/usr/bin/env python3
"""JSON-over-pipes worker behind the Perl binding (swig_torch/BloomFilter.pm),
over the PyTorch / CUDA port.

The reference exports KmerBloomFilter to Perl as ``BloomFilter::
BloomFilter`` through SWIG. The Perl module here (a byte-for-byte copy of
``swig/BloomFilter.pm``) starts the ``bridge_server.py`` that sits beside
the running script and talks to it: one JSON request per line on stdin, one
JSON reply per line on stdout. This worker holds a table of the port's
``compat.KmerBloomFilter`` objects, so Perl sees the SWIG method surface
(insert / contains on k-mers or precomputed hash arrays, storeFilter,
getPop / getHashNum / getKmerSize / getFilterSize, insertSeq) with the
same protocol and op table as ``swig/bridge_server.py``, and the ``.bf``
files it writes are the same bytes.

The filters live on the device ``BTL_BRIDGE_DEVICE`` names: ``cuda`` (the
default) or ``cpu``. Without a CUDA device and without
``BTL_BRIDGE_DEVICE=cpu`` the worker exits with an error at start; it
never moves to the CPU by itself.

Protocol: {"id": n, "op": str, "args": [...]} ->
          {"id": n, "ok": true, "result": ...} |
          {"id": n, "ok": false, "error": str}
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from btl_bloomfilter_tpu_torch import compat  # noqa: E402

DEVICE = os.environ.get("BTL_BRIDGE_DEVICE", "cuda")

_filters = {}
_next_id = [1]


def _new(*args):
    fid = _next_id[0]
    _next_id[0] += 1
    _filters[fid] = compat.KmerBloomFilter(*args, device=DEVICE)
    return fid


_OPS = {
    "new": _new,
    "free": lambda fid: _filters.pop(fid, None) and None,
    "insert": lambda fid, arg: _filters[fid].insert(arg),
    "insertAndCheck":
        lambda fid, arg: bool(_filters[fid].insertAndCheck(arg)),
    "contains": lambda fid, arg: bool(_filters[fid].contains(arg)),
    "storeFilter": lambda fid, path: _filters[fid].storeFilter(path),
    "getPop": lambda fid: _filters[fid].getPop(),
    "getFPR": lambda fid: _filters[fid].getFPR(),
    "getHashNum": lambda fid: _filters[fid].getHashNum(),
    "getKmerSize": lambda fid: _filters[fid].getKmerSize(),
    "getFilterSize": lambda fid: _filters[fid].getFilterSize(),
    "sizeInBytes": lambda fid: _filters[fid].sizeInBytes(),
    "insertSeq":
        lambda fid, seq, h=0, k=0: compat.insertSeq(_filters[fid], seq,
                                                    h, k),
    "ping": lambda: "pong",
}


def check_device() -> None:
    """Refuse to start where the named device is missing."""
    if DEVICE not in ("cuda", "cpu"):
        raise SystemExit(f"bridge_server: BTL_BRIDGE_DEVICE={DEVICE!r}: "
                         "expected cuda or cpu")
    if DEVICE == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bridge_server: no CUDA device; set "
                         "BTL_BRIDGE_DEVICE=cpu to run on the CPU")


def main():
    check_device()
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        req = json.loads(line)
        try:
            result = _OPS[req["op"]](*req.get("args", []))
            reply = {"id": req["id"], "ok": True, "result": result}
        except Exception as e:  # noqa: BLE001 — surface to Perl caller
            reply = {"id": req["id"], "ok": False, "error": repr(e)}
        sys.stdout.write(json.dumps(reply) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
