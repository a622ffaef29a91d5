#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which either passes or ends the script with a non-zero exit
before the result line:

1. Environment: the card (name, power limit), torch and CUDA versions, and
   the build of the hand-written kernels from ``textreid_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the
   serving shapes, with the tolerances stated below.
3. The slice through its entry points at the flagship width
   (``flagship_cfg("")``: CLIP RN50 at 384x128, bi-GRU H=512, T=105,
   seeded weights): ``textreid_torch.tools.build_index`` on a synthetic
   CUHK-PEDES test split, ``textreid_torch.tools.serve`` booted in-process
   on port 0, HTTP ``/search`` and ``/search_image`` requests.  The kernels'
   launch counters are zeroed just before and read just after; the same
   queries through the plain versions on the card must agree.
4. Timings with CUDA events (kernels) or the host clock around work that
   ends in a synchronize (gallery encode, /search latency).

The last line of standard output is the result JSON.  Without a card, or
outside a checkout, the script exits non-zero and prints no result.
"""

import base64
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from contextlib import contextmanager
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# Stated tolerances (kernel against its plain version, same inputs, same card)
K1_TOL = {"float32": 1e-5,   # same f32 math, another summation order
          "bfloat16": 8e-3}  # f32 inside, one bf16 rounding of the output:
                             # 2 ulp of bf16 below 1.0 (h is tanh-bounded)
K2_TOL = 1e-5                # f32 dot products of length 256
SLICE_TOL = 1e-4             # served scores against the plain path


def fail(msg):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches, after a warmup."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(kernel, plain, reps_kernel, reps_plain):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p0 = cuda_ms(plain, reps_plain)
    k0 = cuda_ms(kernel, reps_kernel)
    k1 = cuda_ms(kernel, reps_kernel)
    p1 = cuda_ms(plain, reps_plain)
    return (k0 + k1) / 2, (p0 + p1) / 2


# -- phase 2: kernels against their plain versions ---------------------------

def k1_inputs(batch, dtype, seed, seq=105, hidden=512):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def gates():
        return (torch.randn(batch, seq, 3 * hidden, device=dev, generator=g)
                * 0.6).to(dtype)

    def weight():
        w = torch.rand(hidden, 3 * hidden, device=dev, generator=g) * 2 - 1
        return (w / math.sqrt(hidden)).to(dtype)

    lengths = torch.randint(1, seq + 1, (batch,), device=dev, generator=g,
                            dtype=torch.int32)
    lengths[0] = seq  # a full-length row
    return gates(), gates(), weight(), weight(), lengths


def check_k1():
    import torch
    from textreid_torch.ops import gru

    worst = {}
    for batch in (64, 256):
        for dtype in (torch.float32, torch.bfloat16):
            args = k1_inputs(batch, dtype, seed=batch)
            # the wrapper with serving's pool rule; the plain scan + the rule
            got = gru.bigru_pooled_scan(*args, pool_mode="always")
            want = gru.zero_participation(gru.bigru_pooled_scan_plain(*args),
                                          args[4], 105, "always")
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"K1 B={batch} {name}: {got.shape}/{got.dtype} vs "
                     f"{want.shape}/{want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            log(f"K1 bigru_pooled_fwd B={batch} T=105 H=512 {name}: "
                f"max_abs_err={err:.3e} (tol {K1_TOL[name]:.0e})")
            if not math.isfinite(err) or err > K1_TOL[name]:
                fail(f"K1 B={batch} {name} disagrees with its plain version")
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


def k2_inputs(n_g, seed, n_q=256, dim=256, duplicates=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def unit(n):
        x = torch.randn(n, dim, device="cuda", generator=g)
        return x / x.norm(dim=1, keepdim=True)

    q, gal = unit(n_q), unit(n_g)
    if duplicates:  # exact score ties: the larger row must rank first
        gal[n_g // 2:n_g // 2 + 64] = gal[:64]
        gal[n_g - 1] = gal[3]
        q[:8] = gal[:8]
    return q.contiguous(), gal.contiguous()


def check_k2():
    import torch
    from textreid_torch.ops import ranking

    cases = [(3074, k, 0, False) for k in (1, 10, 64)]
    cases += [(98304, k, 0, False) for k in (1, 10, 64)]
    cases += [(1001, 10, 990, False),   # ragged G, masked tail
              (40, 64, 0, False),       # k > G: sentinel slots
              (3074, 10, 0, True)]      # duplicated rows: exact ties
    worst = 0.0
    for n_g, k, valid, dup in cases:
        q, gal = k2_inputs(n_g, seed=n_g + k, duplicates=dup)
        vals, idx = ranking.topk_similarity(q, gal, k, valid)
        pv, pi = ranking.topk_similarity_plain(q, gal, k, valid)
        torch.cuda.synchronize()
        err = (vals - pv).abs().max().item()
        n_valid = valid or n_g
        scores = q @ gal[:n_valid].T
        swapped = (idx != pi)
        bad = 0
        for r, j in swapped.nonzero().tolist():
            i_k, i_p = idx[r, j].item(), pi[r, j].item()
            if i_k < 0 or i_p < 0 or abs(
                    scores[r, i_k].item() - scores[r, i_p].item()) > K2_TOL:
                bad += 1
        ties_ok = True
        if dup:  # rows 3 and n_g-1 hold one vector: n_g-1 must come first
            row3 = idx[3].tolist()
            ties_ok = row3.index(n_g - 1) < row3.index(3)
        log(f"K2 topk_similarity_f32 Q=256 D=256 G={n_g} k={k} "
            f"valid={n_valid}{' dup' if dup else ''}: max_abs_err={err:.3e} "
            f"(tol {K2_TOL:.0e}), index mismatches={int(swapped.sum())} "
            f"(non-tie {bad}), tie order ok={ties_ok}")
        if not math.isfinite(err) or err > K2_TOL or bad or not ties_ok:
            fail(f"K2 G={n_g} k={k} disagrees with its plain version")
        worst = max(worst, err)
    return worst


# -- phase 3: the slice through its entry points ---------------------------

@contextmanager
def plain_kernels():
    """Route the encoder's fused scan and the index's ranking through their
    plain PyTorch versions, on the same card."""
    import textreid_torch.models.gru as gru_model
    import textreid_torch.serving as serving
    from textreid_torch.ops import gru, ranking

    def plain_scan(xf, xb, w_f, w_b, lengths, pool_mode):
        pooled = gru.bigru_pooled_scan_plain(xf, xb, w_f, w_b, lengths)
        return gru.zero_participation(pooled, lengths, xf.shape[1], pool_mode)

    def plain_topk(queries, gallery, k=10, valid_gallery=0):
        return ranking.topk_similarity_plain(queries, gallery, k,
                                             valid_gallery)

    with mock.patch.object(gru_model, "bigru_pooled_scan", plain_scan), \
            mock.patch.object(serving, "topk_similarity", plain_topk):
        yield


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def check_reply(reply, n, k, meta_ids, what):
    scores = reply["scores"]
    if len(scores) != n or any(len(r) != k for r in scores):
        fail(f"{what}: scores shape is not [{n}, {k}]")
    if len(reply["meta"]) != n or any(len(r) != k for r in reply["meta"]):
        fail(f"{what}: meta shape is not [{n}, {k}]")
    real = min(k, len(meta_ids))  # slots past the gallery are sentinels
    for row, meta in zip(scores, reply["meta"]):
        if any(s is None or not math.isfinite(s) for s in row[:real]):
            fail(f"{what}: non-finite score {row}")
        if any(s is not None for s in row[real:]) or any(
                m != -1 for m in meta[real:]):
            fail(f"{what}: slots past the gallery are not sentinels")
        if any(b > a + 1e-6 for a, b in zip(row[:real], row[1:real])):
            fail(f"{what}: scores not sorted descending {row}")
        if not set(meta[:real]) <= meta_ids:
            fail(f"{what}: meta outside the index")


def agree_with_plain(reply, plain_scores, plain_meta, query_emb, index, what):
    """Served results against the plain path on the card: scores within
    SLICE_TOL, meta equal except where two rows' plain scores tie within
    SLICE_TOL."""
    real = min(plain_scores.shape[1], len(index.gallery_meta))
    got_s = np.asarray(reply["scores"], np.float64)[:, :real]
    got_m = np.asarray(reply["meta"])[:, :real]
    plain_scores, plain_meta = plain_scores[:, :real], plain_meta[:, :real]
    err = float(np.abs(got_s - plain_scores).max())
    row_of = {m: r for r, m in enumerate(index.gallery_meta.tolist())}
    full = query_emb @ index.gallery.float().cpu().numpy().T
    swaps = 0
    for i, j in zip(*np.nonzero(got_m != plain_meta)):
        swaps += 1
        if abs(full[i, row_of[int(got_m[i, j])]] - plain_scores[i, j]) > SLICE_TOL:
            fail(f"{what}: meta {got_m[i, j]} at [{i},{j}] is not a tie of "
                 f"the plain path's {plain_meta[i, j]}")
    if err > SLICE_TOL:
        fail(f"{what}: scores differ from the plain path by {err:.3e}")
    return err, swaps


def write_config(root):
    from textreid_torch.config import flagship_cfg

    cfg = flagship_cfg("")
    cfg.DATASETS.TEST = ("cuhkpedes_test",)
    cfg.DATALOADER.NUM_WORKERS = 4
    cfg.TEST.IMS_PER_BATCH = 64
    path = os.path.join(root, "flagship.yaml")
    with open(path, "w") as f:
        f.write(cfg.dump())
    return cfg, path


def drive_slice(device="cuda", identities=64, images_per_id=4):
    """build_index -> serve -> HTTP, at the flagship width.  Returns the
    running (service, server, thread), the HTTP results and the counts."""
    from textreid_torch.data import make_synthetic_dataset
    from textreid_torch.models import build_model
    from textreid_torch.ops.gru import bigru_pooled_scan
    from textreid_torch.ops.ranking import topk_similarity
    from textreid_torch.tools import build_index, serve
    from textreid_torch.utils.weight_convert import save_reference_checkpoint

    os.makedirs(WORK, exist_ok=True)
    cfg, cfg_path = write_config(WORK)
    height, width = cfg.INPUT.HEIGHT, cfg.INPUT.WIDTH
    data_root = os.path.join(WORK, "data")
    make_synthetic_dataset(
        os.path.join(data_root, "datasets", "cuhkpedes"),
        num_identities=identities, images_per_id=images_per_id,
        image_size=(height, width), vocab_size=cfg.MODEL.GRU.VOCABULARY_SIZE,
        max_tokens=60, split="test")
    ckpt = os.path.join(WORK, "model.pth")
    save_reference_checkpoint(build_model(cfg, "cpu"), ckpt)  # seeded, f32
    index_path = os.path.join(WORK, "gallery.idx")
    common = ["--root", data_root, "--config-file", cfg_path,
              "--checkpoint-file", ckpt, "--device", device]

    bigru_pooled_scan.launches = 0
    topk_similarity.launches = 0
    t0 = time.time()
    build_index.main(common + ["--output", index_path])
    service, server = serve.build_server(
        common + ["--index-file", index_path, "--port", "0",
                  "--k-buckets", "5,10,100", "--reload-dir", WORK])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]

    rng = np.random.RandomState(7)
    seq = cfg.INPUT.MAX_TEXT_LENGTH
    text = []
    for n, k in [(1, 5), (3, 10), (16, 5), (8, 10), (2, 5), (5, 10), (1, 10),
                 (12, 5), (4, 100)]:
        lens = rng.randint(1, seq + 1, n).astype(np.int32)
        ids = np.zeros((n, seq), np.int32)
        for i, ln in enumerate(lens):
            ids[i, :ln] = rng.randint(1, cfg.MODEL.GRU.VOCABULARY_SIZE, ln)
        reply = post(base + "/search", {"token_ids": ids.tolist(),
                                        "lengths": lens.tolist(), "k": k})
        text.append((ids, lens, k, reply))
    images = []
    for n in (1, 2):
        pixels = rng.randint(0, 255, (n, height, width, 3), dtype=np.uint8)
        reply = post(base + "/search_image", {
            "images_b64": [base64.b64encode(p.tobytes()).decode()
                           for p in pixels], "k": 10})
        images.append((pixels, 10, reply))
    counts = {"bigru_pooled_fwd": bigru_pooled_scan.launches,
              "topk_similarity_f32": topk_similarity.launches}
    log(f"slice: build_index + serve boot + {len(text)} /search + "
        f"{len(images)} /search_image in {time.time() - t0:.1f} s; "
        f"launches {counts}")
    return service, server, thread, base, text, images, counts


def check_slice(service, text, images, counts):
    index = service.index
    meta_ids = set(index.gallery_meta.tolist())
    for ids, lens, k, reply in text:
        check_reply(reply, len(ids), k, meta_ids, f"/search n={len(ids)} k={k}")
    for pixels, k, reply in images:
        check_reply(reply, len(pixels), k, meta_ids,
                    f"/search_image n={len(pixels)}")
    for name, n in counts.items():
        if n < 1:
            fail(f"the main path never launched {name}")

    worst, swaps = 0.0, 0
    with plain_kernels():
        for ids, lens, k, reply in text:
            s, m = index.search(ids, lens, k=k)
            emb = index.encode_queries(ids, lens)
            e, w = agree_with_plain(reply, s, m, emb, index, "/search")
            worst, swaps = max(worst, e), swaps + w
        for pixels, k, reply in images:
            s, m = index.search_by_image(pixels, k=k)
            emb = index.encode_image_queries(pixels)
            e, w = agree_with_plain(reply, s, m, emb, index, "/search_image")
            worst, swaps = max(worst, e), swaps + w
    log(f"slice vs plain path on the card: max score diff {worst:.3e} "
        f"(tol {SLICE_TOL:.0e}), meta swaps within ties {swaps}")


# -- phase 4: timings -------------------------------------------------------

def time_kernels():
    import torch
    from textreid_torch.ops import gru, ranking

    out = {}
    for batch in (256, 64):  # the search bucket; encode_queries' chunk
        for dtype in (torch.bfloat16, torch.float32):
            args = k1_inputs(batch, dtype, seed=1)
            ms, plain_ms = interleaved_ms(
                lambda: gru.bigru_pooled_scan(*args, pool_mode="always"),
                lambda: gru.zero_participation(
                    gru.bigru_pooled_scan_plain(*args), args[4], 105,
                    "always"), 10, 3)
            name = str(dtype).split(".")[1]
            out[("K1", batch, name)] = (ms, plain_ms)
            log(f"time K1 B={batch} T=105 H=512 {name}: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms")
    for n_g in (3074, 98304):
        q, gal = k2_inputs(n_g, seed=2)
        ms, plain_ms = interleaved_ms(
            lambda: ranking.topk_similarity(q, gal, 10),
            lambda: ranking.topk_similarity_plain(q, gal, 10), 20, 5)
        out[("K2", n_g)] = (ms, plain_ms)
        log(f"time K2 Q=256 D=256 G={n_g} k=10: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
    return out


def time_serving(service, base, rows=3074, batch=128):
    """Gallery encode img/s of an in-memory gallery, then /search latency
    against it (swapped in over POST /reload_index)."""
    import torch
    from textreid_torch.serving import RetrievalIndex

    cfg_h, cfg_w = service.image_shape
    rng = np.random.RandomState(3)
    pixels = rng.randint(0, 255, (rows, cfg_h, cfg_w, 3), dtype=np.uint8)
    n_batches = -(-rows // batch)
    batches = [pixels[i * batch:(i + 1) * batch] for i in range(n_batches)]
    if len(batches[-1]) < batch:  # pad the tail, as build_index does
        pad = batch - len(batches[-1])
        batches[-1] = np.concatenate([batches[-1], batches[-1][-1:].repeat(
            pad, axis=0)])
    index = RetrievalIndex(service.index.model)
    index.build_gallery(batches[:1])  # warm cuDNN for this shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.build_gallery(batches, valid_rows=rows)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    img_s = rows / encode_s
    log(f"time gallery encode: {rows} images at batch {batch} in "
        f"{encode_s:.3f} s = {img_s:.1f} img/s")

    index.save_index(os.path.join(WORK, "gallery_3074.idx"))
    reply = post(base + "/reload_index", {"file": "gallery_3074.idx"})
    if reply.get("gallery_rows") != rows:
        fail(f"/reload_index: {reply}")
    rng = np.random.RandomState(5)
    lat = []
    for i in range(60):
        ln = int(rng.randint(5, 60))
        ids = rng.randint(1, 512, (1, ln)).tolist()
        t0 = time.perf_counter()
        reply = post(base + "/search", {"token_ids": ids, "k": 10})
        if i >= 10:  # the first requests warm the path
            lat.append((time.perf_counter() - t0) * 1000)
        if len(reply["scores"][0]) != 10:
            fail("/search on the 3074-row gallery returned a short row")
    p50 = float(np.percentile(lat, 50))
    stats = service.stats()
    log(f"time /search (1 query, k=10, {rows} rows, {len(lat)} requests): "
        f"client p50 {p50:.3f} ms, p99 {np.percentile(lat, 99):.3f} ms; "
        f"service device_p50 {stats['device_p50_ms']} ms")
    return img_s, p50


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, REPO)
    try:
        from textreid_torch.ops import _build
        from textreid_torch.utils.platform import require_cuda
    except ImportError as e:
        fail(f"run from the root of a checkout ({e})")

    card = card_line()
    require_cuda("cuda")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.time()
    lib_path, build_log = _build.build()
    _build.library()
    log(f"kernels built in {time.time() - t0:.1f} s: "
        f"{os.path.relpath(lib_path, REPO)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())

    k1_err = check_k1()
    k2_err = check_k2()

    service, server, thread, base, text, images, counts = drive_slice()
    try:
        check_slice(service, text, images, counts)
        times = time_kernels()
        img_s, p50 = time_serving(service, base)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    if "jax" in sys.modules:
        fail("the port imported jax")
    k1_ms, k1_plain = times[("K1", 256, "bfloat16")]
    k2_ms, k2_plain = times[("K2", 3074)]
    log(f"summary: gallery encode {img_s:.1f} img/s, /search p50 {p50:.3f} ms "
        f"({card})")
    log(json.dumps({"kernels": [
        {"name": "bigru_pooled_fwd", "route": "cuda",
         "source": "textreid_torch/csrc/bigru_pooled.cu",
         "replaces": "textreid_tpu/ops/gru_pallas.py:396",
         "launches": counts["bigru_pooled_fwd"],
         "max_abs_err": k1_err["bfloat16"], "ms": k1_ms,
         "plain_ms": k1_plain},
        {"name": "topk_similarity_f32", "route": "cuda",
         "source": "textreid_torch/csrc/topk_similarity.cu",
         "replaces": "textreid_tpu/ops/ranking_pallas.py:211",
         "launches": counts["topk_similarity_f32"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
