#!/usr/bin/env python
"""Smoke test of the align engine on an NVIDIA GPU.

    python chip_smoke.py           # every phase, on one card
    python chip_smoke.py --four    # only the 4-card mesh path and the
                                   # one-card run it is compared with

The parent process only orchestrates: it never imports JAX.  Each phase
runs as its own child process (``python chip_smoke.py --phase NAME``),
one at a time, because a JAX process reserves most of the card's memory
when it first touches it, and a second one would fail.

Phases (one card):
  env     JAX version, devices and compile-cache directory; fails unless
          JAX's platform is ``gpu``.
  golden  ``python -m danbing_tk_tpu align --device ...`` on
          tests/golden/pan with the test suite's flag sets; every output
          byte-compared with the reference goldens, plus the libstdc++
          hash-order probe (tests/test_stdumap.py) on this host's g++.
  scale   the production funnel (DeviceAlignRunner.run_file_native with
          the prefilter, as ``align --device --native-io --prefilter``
          runs it) on the 80k-locus synthetic index over a FlatRPGG host
          view, 1M PE pairs; cold set-up, warm reads/s, steady step ms,
          and an exactness audit of a TR-rich sample against the host
          exact engine on the same index.
  gather  the engine's in-row gathers and scatter, compiled for the card
          at the real widths, against numpy references.
  pred    ``pred --jax`` against the numpy path, byte for byte.
  four    (--four only) ShardedAlignRunner on 4 cards with replicated and
          with sharded tables, on the golden reads and the scale index,
          against a one-card run in the same process.

Every phase must pass.  The last stdout line is then
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
otherwise the script exits 1 and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
WORK = os.path.join(ROOT, "build", "chip_smoke")

PHASES = ("env", "golden", "scale", "gather", "pred")
# seconds per child; the one-card run stays well inside 20 minutes
TIMEOUT = {"env": 120, "golden": 420, "scale": 780, "gather": 240,
           "pred": 180, "four": 1500}

SCALE_NLOCI = 80_000          # the reference's genome-wide locus count
SCALE_P, SCALE_E, SCALE_RETRY = 4096, 768, 4096
SCALE_L = 150                 # read length; device rows are 160 wide
AUDIT_PAIRS = 24_000


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def run_group(cmd, timeout, env=None, cwd=ROOT, echo=None):
    """Runs cmd in its own process group, streaming stdout lines (echoed
    with the ``echo`` prefix, if any); kills the whole group at the
    timeout.  Returns (rc, stdout lines)."""
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            text=True, start_new_session=True)
    killed = []

    def kill():
        killed.append(True)
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    timer = threading.Timer(timeout, kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            lines.append(line)
            if echo is not None:
                log(f"{echo}{line}")
        proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            kill()
            proc.wait()
        else:
            try:                      # stragglers of the group
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    rc = 124 if killed else proc.returncode
    return rc, lines


def nvidia_smi():
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, str(e)
    if r.returncode != 0 or not r.stdout.strip():
        return None, r.stderr.strip() or f"rc={r.returncode}"
    return r.stdout.strip().splitlines(), None


def orchestrate(args) -> int:
    if not os.path.isdir(os.path.join(ROOT, "danbing_tk_tpu")):
        print("chip_smoke: the danbing_tk_tpu package is not next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    smi, err = nvidia_smi()
    if smi is None:
        print(f"chip_smoke: nvidia-smi failed ({err}); no NVIDIA GPU here",
              file=sys.stderr)
        return 1
    for line in smi:
        log(f"nvidia-smi: {line}")
    phases = ("env", "four") if args.four else PHASES
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    device, failed = None, []
    t_all = time.time()
    for ph in phases:
        cmd = [sys.executable, os.path.abspath(__file__), "--phase", ph]
        if args.four:
            cmd.append("--four")
        cmd += ["--kpl", str(args.kpl), "--pairs", str(args.pairs)]
        t0 = time.time()
        log(f"== phase {ph}")
        rc, lines = run_group(cmd, TIMEOUT[ph], env=env, echo=f"[{ph}] ")
        wall = time.time() - t0
        for line in lines:
            if line.startswith("SMOKE_DEVICE "):
                device = json.loads(line[len("SMOKE_DEVICE "):])
        status = "ok" if rc == 0 else f"FAILED rc={rc}"
        log(f"== phase {ph}: {status} ({wall:.1f} s)")
        if rc != 0:
            failed.append(ph)
            if ph == "env":
                break
    log(f"== total wall {time.time() - t_all:.1f} s")
    if failed or device is None:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    for line in smi:
        log(f"card: {line}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phases (child processes)
# ---------------------------------------------------------------------------

def expected_platform() -> str:
    """gpu, unless JAX_PLATFORMS explicitly names cpu (a CPU rehearsal of
    a single phase)."""
    named = {p.strip() for p in os.environ.get("JAX_PLATFORMS", "").split(",")}
    return "cpu" if named == {"cpu"} else "gpu"


def phase_env(args):
    import jax

    from danbing_tk_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    log(f"jax {jax.__version__}")
    log(f"devices: {devs}")
    log(f"compile cache: {cache}")
    d = devs[0]
    log("SMOKE_DEVICE " + json.dumps(
        {"platform": d.platform, "kind": d.device_kind,
         "count": len(devs)}))
    assert d.platform == "gpu", f"JAX platform is {d.platform}, not gpu"
    if args.four:
        assert len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}"


GOLDEN_RUNS = (
    # (name, align flags, {our output: golden file})
    ("counting + .kam + bubbles",
     ["-fa", "reads.fa", "-cth", "20", "-kf", "4", "1", "-bu", "-o"],
     {"out.trkmc.ar": "out.trkmc.ar",
      "out.tr.summary.txt": "out.tr.summary.txt",
      "out.kam": "out.kam", "out.bub.kmdb": "out.bub.kmdb"}),
    ("production --native-io --prefilter --checkpoint -ka",
     ["-fa", "reads.fa", "-cth", "20", "-kf", "4", "1", "--native-io",
      "--prefilter", "--checkpoint", "CKPT", "-ka", "-on"],
     {"out.tr.kmers": "out.on.tr.kmers"}),
    ("fastq + bait, simmode 2",
     ["-fq", "reads.sim.fq", "-cth", "20", "-kf", "4", "1", "-b", "-s",
      "2", "-o"],
     {"out.trkmc.ar": "out.fq.trkmc.ar", "out.kam": "out.fq.kam",
      "out.tr.summary.txt": "out.fq.tr.summary.txt"}),
    ("graph threading -gc 50 3 -a, simmode 2",
     ["-fa", "reads.sim.fa", "-cth", "20", "-kf", "4", "1", "-s", "2",
      "-gc", "50", "3", "-a", "-on"],
     {"out.tr.kmers": "out.thread.tr.kmers", "out.aln": "out.thread.aln"}),
)


def phase_golden(args):
    """CLI runs; this process never imports JAX."""
    import shutil

    plat = expected_platform()
    t0 = time.time()
    subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "native")],
                   check=True, timeout=600)
    log(f"native host libraries built ({time.time() - t0:.1f} s)")
    work = os.path.join(WORK, "golden")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bad = []
    for i, (name, flags, outputs) in enumerate(GOLDEN_RUNS):
        d = os.path.join(work, str(i))
        os.makedirs(d)
        argv = [os.path.join(GOLDEN, f) if f.startswith("reads.") else f
                for f in flags]
        argv = [os.path.join(d, "ck.npz") if f == "CKPT" else f
                for f in argv]
        cmd = [sys.executable, "-m", "danbing_tk_tpu", "align", "--device",
               "-k", "21", "-qs", os.path.join(GOLDEN, "pan")] + argv \
            + [os.path.join(d, "out")]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        wall = time.time() - t0
        if r.returncode != 0:
            log(f"FAIL {name}: rc={r.returncode}\n{r.stderr[-3000:]}")
            bad.append(name)
            continue
        if f"platform={plat}" not in r.stderr:
            log(f"FAIL {name}: device engine did not report platform={plat}"
                f"\n{r.stderr[-1500:]}")
            bad.append(name)
            continue
        diffs = []
        for ours, gold in outputs.items():
            a = open(os.path.join(d, ours), "rb").read()
            b = open(os.path.join(GOLDEN, gold), "rb").read()
            if a != b:
                diffs.append(f"{ours} != {gold} ({len(a)} vs {len(b)} B)")
        engine = [ln for ln in r.stderr.splitlines()
                  if ln.startswith(("device engine:", "referee pairs"))]
        log(f"{'ok  ' if not diffs else 'FAIL'} {name}: {wall:.1f} s, "
            f"{len(outputs)} outputs byte-compared; {'; '.join(engine)}"
            + (f"; {diffs}" if diffs else ""))
        if diffs:
            bad.append(name)
    # .kam / .tr.kmers byte order rests on libstdc++ hash-order emulation;
    # check it against a container built by this host's g++
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                        "no:cacheprovider", "tests/test_stdumap.py"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    tail = r.stdout.strip().splitlines()[-1:] or [r.stderr[-500:]]
    log(f"{'ok  ' if r.returncode == 0 else 'FAIL'} libstdc++ hash order "
        f"(tests/test_stdumap.py): {tail[0]}")
    if r.returncode != 0:
        bad.append("stdumap")
    assert not bad, f"golden phase failures: {bad}"


def _device_table_bytes(drp) -> int:
    import jax

    return sum(int(a.nbytes) for a in jax.tree.leaves(
        list(drp.__dict__.get("_dev_cache", {}).values())))


def _peak_bytes():
    import jax

    st = jax.devices()[0].memory_stats() or {}
    return st.get("peak_bytes_in_use")


def _scale_setup(kpl: int, npairs: int):
    """(drp, flat, reads path, audit reads path, seqs) for the synthetic
    80k-locus index; prints the host set-up walls."""
    from danbing_tk_tpu.engine.flat_rpgg import FlatRPGG
    from tools.bench_e2e import synth_reads
    from tools.make_scale_index import build_scale_rpgg

    import numpy as np

    os.makedirs(WORK, exist_ok=True)
    t0 = time.time()
    drp, seqs = build_scale_rpgg(SCALE_NLOCI, kpl, verbose=False)
    t_index = time.time() - t0
    t0 = time.time()
    flat = FlatRPGG.from_device_tables(drp)
    t_flat = time.time() - t0
    t0 = time.time()
    dec = np.frombuffer(b"ACGT", dtype=np.uint8)[seqs[:20_000]]
    pool = [row.tobytes().decode() for row in dec]
    flen = min(500, seqs.shape[1])
    reads = os.path.join(WORK, f"scale_{kpl}_{npairs}.fa")
    audit = os.path.join(WORK, f"audit_{kpl}_{AUDIT_PAIRS}.fa")
    # 5% of pairs from the panel at 0.2%/base substitutions, the rest a
    # uniform random background; the audit sample is all panel pairs
    synth_reads(reads, npairs, 0.05, pool, L=SCALE_L, err=0.002, flen=flen)
    synth_reads(audit, AUDIT_PAIRS, 1.0, pool, L=SCALE_L, err=0.002,
                flen=flen, seed=11)
    t_reads = time.time() - t0
    log(f"index: {SCALE_NLOCI} loci x {kpl} k-mers/locus, "
        f"{len(flat.dbi)} dbi keys, {drp.nslots} TR slots; host build "
        f"{t_index:.1f} s, flat host view {t_flat:.1f} s, reads "
        f"({npairs} + {AUDIT_PAIRS} pairs) {t_reads:.1f} s")
    return drp, flat, reads, audit, seqs, dict(
        index_s=t_index, flat_s=t_flat, reads_s=t_reads)


def _scale_runner(flat, drp, cfg, steps_from=None):
    """A funnel runner at the scale shapes; reuses the compiled programs
    of ``steps_from`` when given."""
    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner

    al = DeviceAlignRunner(flat, cfg, batch_pairs=SCALE_P,
                           max_read_len=160, expand_cap=SCALE_E,
                           retry_expand=[SCALE_RETRY], drp=drp)
    if steps_from is not None:
        al.step = steps_from.step
        al.retry_steps = steps_from.retry_steps
        al.prefilter_step = steps_from.prefilter_step
        al.prefilter_P = steps_from.prefilter_P
    return al


def _funnel_pass(al, flat, reads):
    import jax.numpy as jnp

    flat.flat_counts()[:] = 0
    t0 = time.time()
    al.run_file_native(reads, prefilter=True)
    int(al.state["counts"].sum(dtype=jnp.uint32))   # device work done
    return time.time() - t0


def _step_ms(al, seqs, nsteps=20):
    """Steady full-step time on one P-pair batch of panel reads."""
    import jax
    import numpy as np

    from tools.make_scale_index import sample_read_batch

    rng = np.random.default_rng(5)
    c, r = sample_read_batch(seqs, SCALE_P, SCALE_L, rng, frac_tr=1.0,
                             flen=min(400, seqs.shape[1]))
    codes = np.full((2 * SCALE_P, al.L), 255, np.uint8)
    codes[:, :SCALE_L] = c
    live = np.ones(SCALE_P, bool)
    codes, rlen, live = (jax.device_put(x) for x in (codes, r, live))
    al.state, out = al.step(al.state, codes, rlen, live)
    jax.block_until_ready(al.state)
    t0 = time.time()
    for _ in range(nsteps):
        al.state, out = al.step(al.state, codes, rlen, live)
    jax.block_until_ready(al.state)
    return 1e3 * (time.time() - t0) / nsteps


def _audit(al, flat, cfg, audit):
    """Device funnel vs the host exact engine on the same FlatRPGG and
    pairs: the flat count arrays must be byte-equal."""
    import numpy as np

    from danbing_tk_tpu.engine import native_referee as nr
    from danbing_tk_tpu.engine.host_align import HostAligner, \
        iter_fasta_pairs

    _funnel_pass(al, flat, audit)
    dev = al.flat_counts().copy()
    dev_nmap = al._dev_state("nmapread")[:-1] + al.host.nmapread
    flat.flat_counts()[:] = 0
    host = HostAligner(flat, cfg)
    assert nr.available(), "build/libdtk_align.so missing"
    eng = nr.NativeReferee(host)
    t0 = time.time()
    npairs = 0
    for batch in iter_fasta_pairs(audit, cfg.cth + cfg.ksize - 1,
                                  flat.nloci, 0, cfg.reads_per_batch // 2):
        for title, s1, s2, src in batch:
            eng.process_pair(title, s1, s2, src)
            npairs += 1
        host.flush_batch()
    ref = host.flat_counts()
    same = bool(np.array_equal(dev, ref)) and bool(
        np.array_equal(dev_nmap, host.nmapread))
    log(f"audit: {npairs} TR-rich pairs, device funnel vs host exact "
        f"engine ({type(eng).__name__}, {time.time() - t0:.1f} s): "
        f"counts byte-equal={bool(np.array_equal(dev, ref))}, "
        f"nmapread equal={bool(np.array_equal(dev_nmap, host.nmapread))}, "
        f"{int(ref.sum())} TR k-mer counts, device referee pairs "
        f"{al.n_referee}")
    return same


def phase_scale(args):
    os.environ.setdefault("DTK_PREFILTER_MULT", "16")
    import jax

    from danbing_tk_tpu.engine.host_align import AlignConfig
    from danbing_tk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    kpl = args.kpl or 1500
    drp, flat, reads, audit, seqs, walls = _scale_setup(kpl, args.pairs)
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False)
    t0 = time.time()
    al = _scale_runner(flat, drp, cfg)
    Pp = SCALE_P * int(os.environ["DTK_PREFILTER_MULT"])
    al.prefilter_step = al._build_prefilter(Pp)
    al.prefilter_P = Pp
    jax.block_until_ready(list(drp._dev_cache.values()))
    t_upload = time.time() - t0
    tab_bytes = _device_table_bytes(drp)
    cold = _funnel_pass(al, flat, reads)
    warm = []
    for _ in range(2):
        al2 = _scale_runner(flat, drp, cfg, steps_from=al)
        warm.append(_funnel_pass(al2, flat, reads))
    surv = args.pairs - al2.n_prefiltered
    step_ms = _step_ms(_scale_runner(flat, drp, cfg, steps_from=al), seqs)
    exact = _audit(_scale_runner(flat, drp, cfg, steps_from=al), flat, cfg,
                   audit)
    res = dict(
        kpl=kpl, dbi_keys=len(flat.dbi), table_bytes=tab_bytes,
        peak_bytes=_peak_bytes(), upload_s=round(t_upload, 2),
        cold_pass_s=round(cold, 2), warm_pass_s=[round(w, 3) for w in warm],
        warm_reads_per_s=round(2 * args.pairs / min(warm)),
        step_ms=round(step_ms, 3), pairs=args.pairs, survivors=surv,
        retried=al2.n_retried, referee=al2.n_referee,
        referee_reasons=al2.referee_reasons, audit_exact=exact,
        **{k: round(v, 1) for k, v in walls.items()})
    log(f"scale: tables {tab_bytes / 1e9:.3f} GB resident as jit "
        f"arguments, peak {res['peak_bytes']} B; upload {t_upload:.1f} s; "
        f"cold pass (compile included) {cold:.1f} s; warm passes "
        f"{res['warm_pass_s']} s -> {res['warm_reads_per_s']} reads/s; "
        f"steady step {step_ms:.2f} ms (P={SCALE_P} E={SCALE_E}); survivors "
        f"{surv}/{args.pairs}, retried {al2.n_retried}, referee "
        f"{al2.n_referee} {al2.referee_reasons}")
    log("SCALE " + json.dumps(res))
    assert exact, "exactness audit failed"
    if expected_platform() == "gpu":
        assert tab_bytes >= 2e9, "less than 2 GB of tables on the device"


def _time_ms(fn, *xs, n=20):
    import jax

    xs = [jax.device_put(x) for x in xs]
    jax.block_until_ready(fn(*xs))
    t0 = time.time()
    for _ in range(n):
        out = fn(*xs)
    jax.block_until_ready(out)
    return 1e3 * (time.time() - t0) / n


def phase_gather(args):
    """The in-row gathers of the step, compiled for the card at P=4096,
    W=280 (2 x 140 k-mer windows of 160-wide rows), E=768, against numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from danbing_tk_tpu.engine import device_align as da

    P, NKW, E, nf = SCALE_P, 140, SCALE_E, 4
    W = 2 * NKW
    EV = W + E
    rng = np.random.default_rng(0)
    bad = []

    def check(name, got, ref, fn, *xs):
        same = all(np.array_equal(np.asarray(g), r) for g, r in zip(got, ref))
        log(f"{'ok  ' if same else 'FAIL'} {name}: {_time_ms(fn, *xs):.3f} "
            f"ms on {jax.devices()[0].device_kind}")
        if not same:
            bad.append(name)

    # prefilter sampling: nf window picks per read from u32 key planes
    klo = rng.integers(0, 2 ** 32, (2 * P, NKW), dtype=np.uint32)
    khi = rng.integers(0, 2 ** 31, (2 * P, NKW), dtype=np.uint32)
    idx = rng.integers(0, NKW, (2 * P, nf)).astype(np.int32)
    f = jax.jit(lambda a, b, i: da._row_gather([a, b], i))
    got = f(klo, khi, idx)
    check("prefilter sample gather (2P x 140 -> 2P x 4, u32)", got,
          [np.take_along_axis(klo, idx, 1), np.take_along_axis(khi, idx, 1)],
          f, klo, khi, idx)

    # covering-run expansion: 16- and 32-bit channels; rows with no
    # expansion at all and rows that overflow E
    nm = np.where(rng.random((P, W)) < 0.08, rng.integers(1, 33, (P, W)), 0)
    nm[: P // 8] = 0
    nm[P // 8: P // 4] *= 4
    csum = np.cumsum(nm, axis=1).astype(np.int32)
    vals = [rng.integers(0, 2 ** 32, (P, W), dtype=np.uint32),
            rng.integers(0, 2 ** 16, (P, W)).astype(np.int32),
            rng.integers(0, 256, (P, W)).astype(np.int32)]
    f = jax.jit(lambda c, *v: da._expand_gather(list(v), c, E))
    got = f(csum, *vals)
    check(f"covering-run expansion (P={P}, W={W} -> E={E}, "
          f"{int((csum[:, -1] == 0).sum())} empty rows, "
          f"{int((csum[:, -1] > E).sum())} overflowing)", got,
          da.expand_gather_np(vals, csum, E), f, csum, *vals)

    # candidate census: prefix-sum gathers over the W+E event plane
    ccum = np.cumsum(rng.integers(0, 2, (P, EV + 1)), 1).astype(np.int32)
    idx = rng.integers(0, EV + 1, (P, EV)).astype(np.int32)
    f = jax.jit(lambda c, i: da._row_gather([c], i))
    got = f(ccum, idx)
    check(f"census gather (P x {EV + 1} -> P x {EV})", got,
          [np.take_along_axis(ccum, idx, 1)], f, ccum, idx)

    # permutation scatter of candidate flags back to event slots
    perm = np.argsort(rng.random((P, EV)), axis=1).astype(np.int32)
    mask = rng.random((P, EV)) < 0.3
    ref = np.zeros((P, EV), bool)
    np.put_along_axis(ref, perm, mask, 1)
    f = jax.jit(lambda m, p: da._row_scatter_bool(m, p, EV))
    got = [f(mask, perm)]
    check(f"permutation scatter (P x {EV})", got, [ref], f, mask, perm)
    assert jnp.asarray(0).devices().pop().platform == expected_platform()
    assert not bad, f"gather mismatches: {bad}"


def _pred_fixture(d):
    """gt.meta / ikmer.meta over four golden genotypes; every 3rd k-mer of
    each locus is invariant, with counts 1-3."""
    import numpy as np

    from danbing_tk_tpu.apps.ktools import ksi
    from danbing_tk_tpu.io import binary as bio

    nk_cum = np.array(ksi(os.path.join(GOLDEN, "pan.tr.kmers")), np.uint32)
    iki, nik, ikc = [], [], []
    prev = 0
    for c in nk_cum:
        cols = range(prev, c, 3)
        iki.extend(cols)
        ikc.extend((i % 3) + 1 for i in cols)
        nik.append(len(iki))
        prev = c
    bio.write_ikmer_meta(os.path.join(d, "ikmer.meta"), nk_cum,
                         np.array(nik, np.uint32), np.array(iki, np.uint32),
                         np.array(ikc, np.uint8))
    with open(os.path.join(d, "gt.meta"), "w") as f:
        for name, depth in (("out.trkmc.ar", "30.0"),
                            ("out.sim.trkmc.ar", "28.5"),
                            ("out.fq.trkmc.ar", "31.7"),
                            ("out.bait.trkmc.ar", "29.3")):
            f.write(f"{GOLDEN}/{name}\t{depth}\n")


# XLA's GPU backend divides f32 with div.full.f32 (at most 2 ulp off the
# IEEE quotient), and the corrected matrix chains four divisions; its
# worst-case relative error stays under 16 ulp
PRED_ULPS = 16


def phase_pred(args):
    """pred --jax vs the numpy path.  The device sums in the numpy path's
    order (no scatter-add atomics), so two device runs are bit-identical
    and the printed bias table equals numpy's byte for byte; the binary
    corrected matrix may differ by the GPU's division rounding, bounded
    by PRED_ULPS."""
    import jax
    import numpy as np

    from danbing_tk_tpu.analysis.pred import run_pred
    from danbing_tk_tpu.io import binary as bio

    d = os.path.join(WORK, "pred")
    os.makedirs(d, exist_ok=True)
    _pred_fixture(d)
    for tag, use_jax in (("np", False), ("jax", True), ("jax2", True)):
        run_pred(os.path.join(d, "gt.meta"), os.path.join(d, "ikmer.meta"),
                 os.path.join(d, f"raw.{tag}"), os.path.join(d, f"corr.{tag}"),
                 os.path.join(d, f"bias.{tag}"), use_jax=use_jax)

    def raw(name):
        return open(os.path.join(d, name), "rb").read()

    bad = [f"{n}.{t}" for n in ("raw", "bias") for t in ("jax", "jax2")
           if raw(f"{n}.{t}") != raw(f"{n}.np")]
    if raw("corr.jax") != raw("corr.jax2"):
        bad.append("corr: device runs differ")
    a = bio.read_gt_matrix(os.path.join(d, "corr.jax"))
    b = bio.read_gt_matrix(os.path.join(d, "corr.np"))
    finite = np.isfinite(a) & np.isfinite(b)
    if not np.array_equal(finite, np.isfinite(b)) or \
            not np.array_equal(a[~finite], b[~finite]):
        bad.append("corr: non-finite entries differ")
    ulps = np.abs(a[finite].view(np.int32).astype(np.int64)
                  - b[finite].view(np.int32).astype(np.int64))
    nulp = int(ulps.max(initial=0))
    if nulp > PRED_ULPS:
        bad.append(f"corr: {nulp} ulp > {PRED_ULPS}")
    log(f"{'ok  ' if not bad else 'FAIL'} pred --jax on "
        f"{jax.devices()[0].device_kind}: bias table and raw matrix "
        f"byte-equal to numpy; corrected matrix max {nulp} ulp from numpy "
        f"({int((ulps > 0).sum())} of {ulps.size} entries differ, bound "
        f"{PRED_ULPS}); two device runs bit-identical="
        f"{raw('corr.jax') == raw('corr.jax2')}" + (f"; {bad}" if bad else ""))
    assert not bad, bad


def phase_four(args):
    """ShardedAlignRunner on 4 cards, replicated and sharded tables, vs a
    one-card DeviceAlignRunner on the same reads in the same process."""
    os.environ.setdefault("DTK_PREFILTER_MULT", "16")
    import jax
    import numpy as np

    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG
    from danbing_tk_tpu.io.binary import read_karray
    from danbing_tk_tpu.parallel import mesh as pm
    from danbing_tk_tpu.parallel.runner import ShardedAlignRunner
    from danbing_tk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    assert len(devs) >= 4, devs
    mesh = pm.make_mesh(devs[:4])
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
    bad = []

    def compare(name, one, got, wall, npairs):
        same = bool(np.array_equal(one, got))
        log(f"{'ok  ' if same else 'FAIL'} {name}: counts byte-equal to the "
            f"one-card run={same} ({wall:.1f} s, {2 * npairs / wall:.0f} "
            f"reads/s incl. compile)")
        if not same:
            bad.append(name)

    # golden panel and reads
    reads = os.path.join(GOLDEN, "reads.fa")
    kw = dict(batch_pairs=1024, max_read_len=192, expand_cap=128,
              retry_expand=512)
    t0 = time.time()
    one = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")), cfg, **kw)
    one.run_file_native(reads, prefilter=True)
    ref = one.flat_counts()
    gold = read_karray(os.path.join(GOLDEN, "out.trkmc.ar"))
    log(f"golden one-card: counts == reference golden: "
        f"{bool((ref == gold).all())} ({time.time() - t0:.1f} s)")
    if not (ref == gold).all():
        bad.append("golden one-card")
    for shard_index in (False, True):
        t0 = time.time()
        r = ShardedAlignRunner(RPGG(os.path.join(GOLDEN, "pan")), cfg,
                               mesh=mesh, shard_index=shard_index, **kw)
        r.run_file_native(reads, prefilter=True)
        compare(f"golden 4-card, {'sharded' if shard_index else 'replicated'}"
                f" tables", ref, r.flat_counts(), time.time() - t0, 4595)

    # scale index (k-mers per locus cut to keep the 4-card call short)
    kpl = args.kpl or 200
    npairs = args.pairs
    drp, flat, reads, _audit_reads, _seqs, _ = _scale_setup(kpl, npairs)
    t0 = time.time()
    one = _scale_runner(flat, drp, cfg)
    wall = _funnel_pass(one, flat, reads)
    ref = one.flat_counts().copy()
    log(f"scale one-card: {wall:.1f} s incl. compile, survivors "
        f"{npairs - one.n_prefiltered}, retried {one.n_retried}, referee "
        f"{one.n_referee}")
    del one
    for shard_index in (False, True):
        r = ShardedAlignRunner(flat, cfg, mesh=mesh, shard_index=shard_index,
                               batch_pairs=SCALE_P, max_read_len=160,
                               expand_cap=SCALE_E, retry_expand=[SCALE_RETRY],
                               drp=drp)
        wall = _funnel_pass(r, flat, reads)
        compare(f"scale 4-card, {'sharded' if shard_index else 'replicated'}"
                f" tables ({len(flat.dbi)} dbi keys)", ref, r.flat_counts(),
                wall, npairs)
        del r
    assert not bad, bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card mesh path and its comparison")
    p.add_argument("--phase", choices=PHASES + ("four",),
                   help=argparse.SUPPRESS)
    p.add_argument("--kpl", type=int, default=0,
                   help="k-mers per locus of the scale index (default "
                        "1500; 200 with --four)")
    p.add_argument("--pairs", type=int, default=0,
                   help="read pairs of the scale funnel (default 1M; "
                        "200k with --four)")
    args = p.parse_args(argv)
    if not args.pairs:
        args.pairs = 200_000 if args.four else 1_000_000
    if args.phase is None:
        return orchestrate(args)
    sys.path.insert(0, ROOT)
    globals()[f"phase_{args.phase}"](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
