"""Drive the PyTorch port's embedding-serving path once on an NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the hand-written kernels from the sources in the checkout: K1
   (``mmlearn_tpu_torch/csrc/fused_attention.cu``, CUDA C++ for sm_90a, into
   ``build/kernels/``) and K2 (Triton, ``mmlearn_tpu_torch/ops/fused_norm.py``);
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes, with the tolerance printed on each line, and time
   both at batch 256;
3. build the full-width flagship (CLIP ViT-B/16 + text tower, random
   weights from a fixed seed, bf16 compute), check that one tower forward
   launches K1 ``depth`` times and K2 ``2 * depth`` times, and time
   ``encode`` at batch 256;
4. the main path, with every launch count set to 0 first: write an rgb and
   a text artifact with ``save_encoder``, embed 8,192 synthetic images into
   ``.npz`` shards plus a manifest, start two ``serve()`` servers on
   127.0.0.1 (image->image and text->image search over the same index), and
   send ``/healthz``, ``/embed`` and ``/search`` to each;
5. check the results: finite, unit-norm embeddings; every queried indexed
   image found at rank 1 with score ~1; served embeddings agree with the
   port's plain-version forward (the same artifact on the CPU).

The lines before the last give the card's name and power limit (from
``nvidia-smi``), the kernels' errors and times, ``encode`` throughput and
``/search`` latency, and one JSON line of per-kernel results. The last line
is ``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(REPO, "build", "chip_smoke")
SEED = 0
BATCH = 256  # encode / kernel-timing batch
N_IMAGES = 8192  # indexed corpus
SHARD_ROWS = 2048
SEARCH_K = 5
LATENCY_QUERIES = 24

# kernel-versus-plain tolerances, |kernel - plain| <= ATOL + RTOL * |plain|:
# bf16 outputs differ by about one bf16 rounding (2^-8 relative) of values
# up to a few units -- K1 rounds unnormalised p where the plain version
# rounds p / l, K2 sums the row in another order; f32 by summation order.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (2e-5, 0.0)}
# served embeddings (bf16 kernels on the card) against the plain-version
# forward of the same artifact on the CPU: cosine of each pair
MIN_COSINE = 0.99
# self-retrieval: a bf16 embedding against its own f32 copy in the index
SELF_SCORE_ATOL = 2e-2


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events over ``iters`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ragged_text(gen, batch: int, length: int, vocab: int, device):
    """Token ids with right padding of ragged lengths: ids in [1, vocab-2],
    the end-of-text id (vocab - 1, the row maximum) at ``len - 1``, pad id 0
    after it, and the matching 0/1 ``int32`` attention mask."""
    import torch

    lens = torch.randint(2, length + 1, (batch,), generator=gen, device=device)
    ids = torch.randint(1, vocab - 1, (batch, length), generator=gen, device=device)
    pos = torch.arange(length, device=device)[None]
    ids = torch.where(pos == lens[:, None] - 1, vocab - 1, ids)
    ids = torch.where(pos < lens[:, None], ids, 0).to(torch.int32)
    return ids, (pos < lens[:, None]).to(torch.int32)


# ----------------------------------------------------------------- kernels


def compare(name: str, got, want, dtype_name: str) -> float:
    atol, rtol = TOL[dtype_name]
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    max_err = float(err.max())
    ok = bool((err <= bound).all()) and bool(got.isfinite().all())
    print(f"{name}: max_abs_err={max_err:.3e} (tol atol={atol:g} rtol={rtol:g}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return max_err


def kernel_phase(device) -> dict:
    """K1 and K2 against their plain versions, then timed at batch 256."""
    import torch

    from mmlearn_tpu_torch.ops import fused_attention as fa
    from mmlearn_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device=device).manual_seed(SEED)

    def qkv(b, n, h, d, dtype):
        return torch.randn(b, n, 3 * h * d, generator=gen, device=device).to(dtype)

    def k1_cases(b):
        ids, mask = ragged_text(gen, b, 77, 64, device)
        left = mask.flip(1).bool()  # left padding: every row's keys masked
        return [  # (label, n, heads, head_dim, mask, causal, dtype)
            ("image", 197, 12, 64, None, False, torch.bfloat16),
            ("text causal", 77, 8, 64, None, True, torch.bfloat16),
            ("text causal+ragged mask", 77, 8, 64, mask.bool(), True, torch.bfloat16),
            ("text causal+left-pad mask", 77, 8, 64, left, True, torch.bfloat16),
            ("D=32", 197, 12, 32, None, False, torch.bfloat16),
            ("D=32 causal+mask", 77, 8, 32, mask.bool(), True, torch.bfloat16),
            ("f32 image", 197, 12, 64, None, False, torch.float32),
            ("f32 D=32 causal+mask", 77, 8, 32, mask.bool(), True, torch.float32),
        ]

    k1_err = 0.0
    for label, n, h, d, mask, causal, dtype in k1_cases(8):
        x = qkv(8, n, h, d, dtype)
        got = fa.fused_mha(x, mask, num_heads=h, causal=causal)
        want = fa.mha_reference(x, mask, h, d ** -0.5, causal)
        torch.cuda.synchronize()
        err = compare(f"K1 fused_mha {label} B=8 N={n} H={h} D={d} {str(dtype)[6:]}",
                      got, want, str(dtype)[6:])
        k1_err = max(k1_err, err)

    k2_err = 0.0
    for n, c in ((197, 768), (77, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(8, n, c, generator=gen, device=device).to(dtype)
            br = torch.randn(8, n, c, generator=gen, device=device).to(dtype)
            g = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
            b = 0.1 * torch.randn(c, generator=gen, device=device)
            tag = f"B=8 N={n} C={c} {str(dtype)[6:]}"
            y = fn.fused_layernorm(x, g, b, eps=1e-6)
            r, y2 = fn.fused_add_layernorm(x, br, g, b, eps=1e-5)
            torch.cuda.synchronize()
            k2_err = max(
                k2_err,
                compare(f"K2 layernorm {tag}", y, fn.ln_reference(x, g, b, 1e-6),
                        str(dtype)[6:]),
                compare(f"K2 add+layernorm r {tag}", r, x + br, str(dtype)[6:]),
                compare(f"K2 add+layernorm y {tag}", y2,
                        fn.ln_reference(x + br, g, b, 1e-5), str(dtype)[6:]),
            )

    # times at the serving path's shapes, batch 256, bf16
    times = {}
    for label, n, h, causal, mask in (
        ("image N=197 H=12", 197, 12, False, None),
        ("text N=77 H=8 causal", 77, 8, True, None),
        ("text N=77 H=8 causal+mask", 77, 8, True,
         ragged_text(gen, BATCH, 77, 64, device)[1].bool()),
    ):
        x = qkv(BATCH, n, h, 64, torch.bfloat16)
        ms = cuda_ms(lambda: fa.fused_mha(x, mask, num_heads=h, causal=causal))
        plain = cuda_ms(lambda: fa.mha_reference(x, mask, h, 0.125, causal))
        times[f"K1 {label}"] = (ms, plain)
    for label, n, c in (("N=197 C=768", 197, 768), ("N=77 C=512", 77, 512)):
        x = torch.randn(BATCH, n, c, generator=gen, device=device).bfloat16()
        br = torch.randn(BATCH, n, c, generator=gen, device=device).bfloat16()
        g = torch.ones(c, device=device)
        b = torch.zeros(c, device=device)
        times[f"K2 layernorm {label}"] = (
            cuda_ms(lambda: fn.fused_layernorm(x, g, b)),
            cuda_ms(lambda: fn.ln_reference(x, g, b, 1e-6)),
        )
        times[f"K2 add+layernorm {label}"] = (
            cuda_ms(lambda: fn.fused_add_layernorm(x, br, g, b)),
            cuda_ms(lambda: (lambda r: (r, fn.ln_reference(r, g, b, 1e-6)))(x + br)),
        )
    for label, (ms, plain) in times.items():
        print(f"time {label} B={BATCH} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return {
        "k1": {"max_abs_err": k1_err, "ms": times["K1 image N=197 H=12"]},
        "k2": {"max_abs_err": k2_err, "ms": times["K2 add+layernorm N=197 C=768"]},
    }


# --------------------------------------------------------------- main path


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.status, json.loads(r.read())


def _post(port: int, path: str, payload: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _start(server) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def write_index(task, device, index_dir: str):
    """Embed N_IMAGES synthetic images (standard-normal pixels drawn on the
    card from SEED) in batches of BATCH into ``.npz`` shards plus a
    manifest, laid out as the JAX package's ``EmbeddingExport`` writes
    them. Returns the images' generator so queries can redraw them."""
    import numpy as np
    import torch

    os.makedirs(index_dir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    shards, buf, done = [], [], 0
    with torch.inference_mode():
        while done < N_IMAGES:
            imgs = torch.randn(BATCH, 224, 224, 3, generator=gen, device=device)
            buf.append(task.encode({"rgb": imgs}, "rgb", normalize=True).float().cpu())
            done += BATCH
            if sum(len(b) for b in buf) >= SHARD_ROWS or done >= N_IMAGES:
                emb = torch.cat(buf).numpy()
                start = done - len(emb)
                name = f"rgb_{len(shards):05d}.npz"
                np.savez(os.path.join(index_dir, name), embeddings=emb,
                         example_index=np.arange(start, done),
                         dataset_index=np.zeros(len(emb), np.int64))
                shards.append(name)
                buf = []
    with open(os.path.join(index_dir, "manifest.json"), "w") as f:
        json.dump({"rgb": {"shards": shards, "rows": done, "dim": 512,
                           "normalized": True}}, f, indent=2)


def indexed_images(device, ids):
    """Redraw indexed images ``ids`` exactly as :func:`write_index` drew them
    (a numpy array, one image per id)."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    want = sorted(set(ids))
    out = {}
    for batch_start in range(0, max(want) + 1, BATCH):
        imgs = torch.randn(BATCH, 224, 224, 3, generator=gen, device=device)
        for i in want:
            if batch_start <= i < batch_start + BATCH:
                out[i] = imgs[i - batch_start].cpu().numpy()
    return np.stack([out[i] for i in ids])


def main_path(device) -> dict:
    import numpy as np
    import torch

    from mmlearn_tpu_torch.flagship import TEXT_LENGTH, VOCAB_SIZE, flagship_task
    from mmlearn_tpu_torch.ops import fused_attention as fa
    from mmlearn_tpu_torch.ops import fused_norm as fn
    from mmlearn_tpu_torch.serving import load_encoder, save_encoder
    from mmlearn_tpu_torch.serving.server import ServingState, serve

    def reset_counts():
        fa.LAUNCHES["fused_mha_fwd"] = 0
        fn.LAUNCHES["layernorm_fwd"] = 0

    def counts():
        return fa.LAUNCHES["fused_mha_fwd"], fn.LAUNCHES["layernorm_fwd"]

    t0 = time.perf_counter()
    task = flagship_task(device, seed=SEED)
    print(f"flagship built on {device} in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in task.parameters()) / 1e6:.1f} M params)")
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    imgs = torch.randn(BATCH, 224, 224, 3, generator=gen, device=device)
    ids, mask = ragged_text(gen, BATCH, TEXT_LENGTH, VOCAB_SIZE, device)
    text_batch = {"text": ids, "text_attention_mask": mask}

    # one tower forward = depth launches of K1 and 2 * depth of K2
    for modality, batch in (("rgb", {"rgb": imgs[:4]}),
                            ("text", {k: v[:4] for k, v in text_batch.items()})):
        depth = len(task.encoders[modality].blocks)
        reset_counts()
        with torch.inference_mode():
            task.encode(batch, modality, normalize=True)
        torch.cuda.synchronize()
        print(f"launches in one {modality} forward: K1 {counts()[0]}, "
              f"K2 {counts()[1]} (depth {depth})")
        check(counts() == (depth, 2 * depth),
              f"{modality} forward launched {counts()}, want ({depth}, {2 * depth})")

    # encode throughput at batch 256 (inputs already on the card)
    for modality, batch, unit in (("rgb", {"rgb": imgs}, "images"),
                                  ("text", text_batch, "texts")):
        with torch.inference_mode():
            ms = cuda_ms(lambda: task.encode(batch, modality, normalize=True),
                         iters=10, warmup=2)
        print(f"encode {modality} b{BATCH}: {ms:.2f} ms/batch = "
              f"{BATCH / ms * 1e3:.1f} {unit}/s")

    # ---- the main path: artifacts, index, two servers, requests
    reset_counts()
    rgb_art = os.path.join(WORK_DIR, "artifact_rgb")
    text_art = os.path.join(WORK_DIR, "artifact_text")
    index_dir = os.path.join(WORK_DIR, "index")
    example = {k: v[:2].cpu().numpy() for k, v in text_batch.items()}
    save_encoder(rgb_art, task, "rgb", {"rgb": imgs[:2].cpu().numpy()})
    save_encoder(text_art, task, "text", example)
    t0 = time.perf_counter()
    write_index(task, device, index_dir)
    torch.cuda.synchronize()
    print(f"indexed {N_IMAGES} images in {time.perf_counter() - t0:.1f} s")

    rgb_server = serve(rgb_art, port=0, index_dir=index_dir, device=device)
    text_server = serve(text_art, port=0, index_dir=index_dir, index_modality="rgb",
                        device=device)
    threads = [_start(rgb_server), _start(text_server)]
    results: dict = {}
    try:
        rport = rgb_server.server_address[1]
        tport = text_server.server_address[1]
        for port, modality in ((rport, "rgb"), (tport, "text")):
            status, health = _get(port, "/healthz")
            check(status == 200 and health["status"] == "ok"
                  and health["modality"] == modality and health["index_rows"] == N_IMAGES,
                  f"/healthz {modality}: {status} {health}")

        query_ids = [0, 1, 4095, N_IMAGES - 1]
        q_imgs = indexed_images(device, query_ids)
        status, out = _post(rport, "/embed", {"inputs": {"rgb": q_imgs.tolist()}})
        check(status == 200, f"/embed rgb: {status} {out}")
        rgb_emb = np.asarray(out["embeddings"], np.float32)
        status, out = _post(rport, "/search",
                            {"inputs": {"rgb": q_imgs.tolist()}, "k": SEARCH_K})
        check(status == 200, f"/search rgb: {status} {out}")
        top = np.asarray(out["example_index"])
        scores = np.asarray(out["scores"])
        check(top.shape == (4, SEARCH_K) and top[:, 0].tolist() == query_ids,
              f"/search rgb rank-1 ids {top[:, 0].tolist()}, want {query_ids}")
        check(np.all(np.abs(scores[:, 0] - 1) <= SELF_SCORE_ATOL),
              f"/search rgb self scores {scores[:, 0]}")

        texts = {k: v[:4].cpu().numpy().tolist() for k, v in text_batch.items()}
        status, out = _post(tport, "/embed", {"inputs": texts})
        check(status == 200, f"/embed text: {status} {out}")
        text_emb = np.asarray(out["embeddings"], np.float32)
        status, out = _post(tport, "/search", {"inputs": texts, "k": SEARCH_K})
        check(status == 200, f"/search text: {status} {out}")
        t_top = np.asarray(out["example_index"])
        t_scores = np.asarray(out["scores"])
        check(t_top.shape == (4, SEARCH_K) and t_top.min() >= 0
              and t_top.max() < N_IMAGES, f"/search text ids {t_top}")
        check(bool(np.all(np.diff(t_scores, axis=1) <= 0)), "text scores not sorted")
        status, out = _post(tport, "/embed", {"inputs": {"text": texts["text"]}})
        check(status == 400, f"/embed without the mask key answered {status}")

        # b=1 /search latency over HTTP, every query an indexed image
        lat_ids = [int(i) for i in np.linspace(0, N_IMAGES - 1, LATENCY_QUERIES)]
        lat_imgs = indexed_images(device, lat_ids)
        lat = []
        for i, img in zip(lat_ids, lat_imgs):
            body = {"inputs": {"rgb": img[None].tolist()}, "k": SEARCH_K}
            t0 = time.perf_counter()
            status, out = _post(rport, "/search", body)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and out["example_index"][0][0] == i
                  and abs(out["scores"][0][0] - 1) <= SELF_SCORE_ATOL,
                  f"/search b=1 image {i}: {status} {out}")
        results["http_p50_ms"] = statistics.median(lat)
        results["http_max_ms"] = max(lat)
    finally:
        for server in (rgb_server, text_server):
            server.shutdown()
            server.server_close()
        for t in threads:
            t.join(timeout=30)
    results["launches"] = counts()
    print(f"main path launches: K1 {counts()[0]}, K2 {counts()[1]}")
    check(all(c > 0 for c in counts()), f"a kernel never launched: {counts()}")
    print(f"/search b=1 over HTTP: p50 {results['http_p50_ms']:.2f} ms, max "
          f"{results['http_max_ms']:.2f} ms ({LATENCY_QUERIES} requests, "
          f"{SEARCH_K}-NN over {N_IMAGES} images; JSON of 224x224x3 pixels)")

    # the same b=1 search in process: encode + index query, no HTTP/JSON
    state = ServingState(rgb_art, index_dir, device=device)
    lat = []
    for img in lat_imgs:
        t0 = time.perf_counter()
        state.search({"rgb": img[None]}, k=SEARCH_K)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"/search b=1 in process (encode + query): p50 "
          f"{statistics.median(lat[2:]):.2f} ms over {len(lat) - 2} queries")

    # outputs: finite, unit norm, and equal to the plain-version forward
    for modality, emb in (("rgb", rgb_emb), ("text", text_emb)):
        norms = np.linalg.norm(emb, axis=1)
        check(bool(np.isfinite(emb).all()) and emb.shape == (4, 512),
              f"{modality} embeddings {emb.shape} not finite")
        check(bool(np.all(np.abs(norms - 1) <= SELF_SCORE_ATOL)),
              f"{modality} embedding norms {norms}")
    plain = {
        "rgb": load_encoder(rgb_art, device="cpu")({"rgb": q_imgs}),
        "text": load_encoder(text_art, device="cpu")(
            {k: np.asarray(v, np.int32) for k, v in texts.items()}),
    }
    for modality, emb in (("rgb", rgb_emb), ("text", text_emb)):
        ref = plain[modality].float().numpy()
        cos = (emb * ref).sum(1) / np.linalg.norm(emb, axis=1) / np.linalg.norm(ref, axis=1)
        print(f"served {modality} embeddings vs plain-version forward on CPU: "
              f"min cosine {cos.min():.6f} (bound {MIN_COSINE})")
        check(bool(cos.min() >= MIN_COSINE), f"{modality} cosine {cos}")
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card and has nothing to run here",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from mmlearn_tpu_torch import _build

    t0 = time.perf_counter()
    lib = _build.build("fused_attention")
    print(f"built K1 {os.path.relpath(lib, REPO)} in {time.perf_counter() - t0:.1f} s")

    kernels = kernel_phase(device)
    results = main_path(device)
    k1_launches, k2_launches = results["launches"]
    print(json.dumps({"kernels": [
        {"name": "fused_mha_fwd", "route": "cuda",
         "source": "mmlearn_tpu_torch/csrc/fused_attention.cu",
         "replaces": "mmlearn_tpu/ops/fused_attention.py:173",
         "launches": k1_launches, "max_abs_err": kernels["k1"]["max_abs_err"],
         "ms": kernels["k1"]["ms"][0], "plain_ms": kernels["k1"]["ms"][1]},
        {"name": "layernorm_fwd", "route": "triton",
         "source": "mmlearn_tpu_torch/ops/fused_norm.py",
         "replaces": "mmlearn_tpu/ops/fused_norm.py:126",
         "launches": k2_launches, "max_abs_err": kernels["k2"]["max_abs_err"],
         "ms": kernels["k2"]["ms"][0], "plain_ms": kernels["k2"]["ms"][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
