"""Four-card check of the placed sharded serve: a controlled serve of
qwen3-32b at full width and 4 layers (`--mesh host:4 --control-every 2`,
ctrl garbage written into shard 2's lane after step 7), first on one card
(four shard lanes), then placed one shard a card under torchrun (graphs,
each rank through `chip_smoke.placed_rank`, which ends through the serve
CLI's teardown), held bitwise: tokens, report lines, journal rows and
each rank's lane of the one-card cache. Then the 2-rank NCCL graph test of
`tests/test_torch_gpu.py`. Needs 4 cards; run from the repository root:

    python3 tools/placed_check.py

Logs go under chiprun_out/r18; the last line says whether all held."""
import contextlib, dataclasses, gc, io, json, os, pathlib, signal
import subprocess, sys, tempfile, time
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT)); sys.path.insert(0, str(ROOT / "src"))
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import backend
from repro_torch.launch import serve

T0 = time.perf_counter()
print(subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
backend.build(verbose=False)
print(f"built at {time.perf_counter() - T0:.1f} s", flush=True)
logdir = ROOT / "chiprun_out" / "r18"
logdir.mkdir(parents=True, exist_ok=True)
LAYERS = 4
cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=LAYERS)
argv = ["--arch", "qwen3-32b", "--reuse", "--batch-slots", "8", "--requests",
        "8", "--prompt-len", "32", "--cache-len", "128", "--max-new", "16",
        "--mesh", "host:4", "--control-every", "2", "--inject",
        "ctrl-garbage:at_step=7,site=mlp_out,layer=1,shard=2"]
ok = True
with tempfile.TemporaryDirectory() as tmp:
    j1 = os.path.join(tmp, "one.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve.run(cfg, serve.build_parser().parse_args(
            argv + ["--control-journal", j1]))
    torch.cuda.synchronize()
    want = cs.host_outcome(cs.outcome(res, buf.getvalue()))
    want_rows = cs.journal_rows(j1)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    print(f"one-card host:4 serve done at {time.perf_counter() - T0:.1f} s; "
          f"{len(want_rows)} journal rows; "
          + " | ".join(ln for ln in buf.getvalue().splitlines()
                       if "inject" in ln or "quarantine" in ln)[:600],
          flush=True)
    j2 = logdir / "placed.jsonl"
    j2.unlink(missing_ok=True)
    try:
        recs, lanes = cs.placed_serve(
            ROOT, "review", "qwen3-32b", LAYERS,
            argv + ["--control-journal", str(j2)], "graph", logdir)
        cs.check_ranks("review", recs)
        tokens = {int(k): v for k, v in recs[0]["tokens"].items()}
        rows = cs.journal_rows(j2)
        print("tokens equal:", tokens == want["tokens"],
              "| reports equal:", recs[0]["reports"] == want["reports"],
              "| journal equal:", rows == want_rows, len(rows), flush=True)
        ok &= tokens == want["tokens"] and recs[0]["reports"] == \
            want["reports"] and rows == want_rows
        whole = cs.lanes_side_by_side("review", lanes, want["tensors"])
        print(f"lanes equal the one-card cache: {len(whole)} tensors")
        for rec in recs:
            print({k: rec.get(k) for k in (
                "rank", "card", "replay_ms", "kernels_replay",
                "allgathers_replay", "allgather_ms", "peak_mb")})
        print("\n".join(ln for ln in recs[0]["text"].splitlines()
                        if ln.startswith(("mesh", "profiler", "ici",
                                          "shard skip", "fault", "  ctrl",
                                          "inject"))))
    except SystemExit as e:  # chip_smoke.fail: report, go on to the test
        ok = False
        print("placed serve FAILED:", repr(e)[:3000], flush=True)
print(f"placed serve done at {time.perf_counter() - T0:.1f} s", flush=True)
t0 = time.perf_counter()
p = subprocess.Popen(
    [sys.executable, "-m", "pytest", "-q", "-rs", "-p", "no:cacheprovider",
     "-m", "gpu", "-k", "placed_panels", "--basetemp", str(logdir / "gpu"),
     "tests/test_torch_gpu.py"], cwd=ROOT,
    env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), NCCL_DEBUG="WARN"),
    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    start_new_session=True)
try:
    out, _ = p.communicate(timeout=200)
    rc = p.returncode
except subprocess.TimeoutExpired:
    os.killpg(p.pid, signal.SIGKILL)
    out, _ = p.communicate()
    rc = "timeout"
subprocess.run(["pkill", "-9", "-f", "ranks.py"])
print(f"gpu test rc={rc} in {time.perf_counter() - t0:.1f} s\n{out[-4000:]}")
for log in (logdir / "gpu").rglob("ranks.log"):
    print(log, log.read_text()[-4000:])
print(f"total {time.perf_counter() - T0:.1f} s; ok={ok and rc == 0}")
sys.exit(0 if ok and rc == 0 else 1)
