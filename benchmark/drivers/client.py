"""The viewer's client: one closed-loop user, as ``viewer/index.html`` keeps
one request in flight. Runs as a child process of the run, on the standard
library alone, so that it shares no interpreter with the server.

    python3 client.py '<json arguments>'

It reads ``/info`` (centre and radius, as the page does), sends warm-up
requests, then for ``seconds`` asks ``/render`` for frames in the order of
the traffic's pattern, each timed from sending the request to its body's
last byte. The query is the page's, with its four decimals. It prints one
JSON object: the window's start and end (``time.perf_counter``, the system's
monotonic clock), each request's fields and outcome, and the bodies of a
sample of the requests drawn from the seed, the last full frame among them.
"""

import base64
import http.client
import json
import math
import os
import random
import struct
import sys
import time


def get(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def jpeg_size(body):
    """(width, height) of a baseline JPEG's SOF0, or None."""
    if body[:2] != b"\xff\xd8":
        return None
    i = 2
    while i + 4 <= len(body) and body[i] == 0xFF:
        marker, length = body[i + 1], struct.unpack(">H", body[i + 2:i + 4])[0]
        if marker == 0xC0:
            h, w = struct.unpack(">HH", body[i + 5:i + 9])
            return w, h
        i += 2 + length
    return None


def plan(args, info, i):
    """The fields of request ``i`` of the pattern."""
    period = [r["lores"] for r in args["pattern"] for _ in range(r["count"])]
    lores = period[i % len(period)]
    az = args["az0"] + i * args["az_step"]
    el = args["el_base"] + args["el_amp"] * math.sin(az)
    w, h = args["width"], args["height"]
    cx, cy, cz = info["center"]
    q = (f"/render?az={az:.4f}&el={el:.4f}&r={info['radius']:.4f}&cx={cx:.4f}&cy={cy:.4f}"
         f"&cz={cz:.4f}&w={w}&h={h}&mode=normal&markers=0&cloud=0&cloud_mode=rgb&axes=0&grid=0"
         + ("&lores=1" if lores else ""))
    div = args["lores_div"] if lores else 1
    size = (max(64, w // div), max(48, h // div)) if lores else (w, h)
    return {"path": q, "lores": lores, "az": float(f"{az:.4f}"), "el": float(f"{el:.4f}"),
            "r": float(f"{info['radius']:.4f}"),
            "center": [float(f"{c:.4f}") for c in (cx, cy, cz)], "size": size}


def request(args, fields):
    t0 = time.perf_counter()
    status, ctype, body = get(args["host"], args["port"], fields["path"])
    t1 = time.perf_counter()
    ok = status == 200 and ctype == "image/jpeg" and jpeg_size(body) == tuple(fields["size"])
    return t0, t1, status, ok, body


def main():
    args = json.loads(sys.argv[1])
    if args.get("core") is not None:  # a core of its own, apart from the server's
        os.sched_setaffinity(0, {args["core"]})
    _, _, raw = get(args["host"], args["port"], "/info")
    info = json.loads(raw)
    period = sum(r["count"] for r in args["pattern"])
    for j in range(args["warmup"]):  # every kind of request in the pattern
        request(args, plan(args, info, -1 - j * period // max(1, args["warmup"])))
    reqs, bodies = [], []
    t_start = time.perf_counter()
    deadline = t_start + args["seconds"]
    i = 0
    while time.perf_counter() < deadline:
        fields = plan(args, info, i)
        t0, t1, status, ok, body = request(args, fields)
        reqs.append({"t0": t0, "t1": t1, "status": status, "ok": ok, "bytes": len(body),
                     **{k: fields[k] for k in ("lores", "az", "el", "r", "center", "size")}})
        bodies.append(body)
        i += 1
    t_end = time.perf_counter()
    rng = random.Random(args["seed"])
    n = len(reqs)
    sample = sorted(rng.sample(range(n), min(args["sample"], n)))
    full = [j for j in range(n) if not reqs[j]["lores"]]
    if full and not any(not reqs[j]["lores"] for j in sample):
        sample[-1] = full[-1]
    out = {"t_start": t_start, "t_end": t_end, "warmup": args["warmup"], "requests": reqs,
           "sample": {str(j): base64.b64encode(bodies[j]).decode() for j in sample}}
    sys.stdout.write(json.dumps(out))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
