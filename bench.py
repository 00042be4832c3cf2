#!/usr/bin/env python
"""Driver-captured benchmark ORCHESTRATOR.

Round-4 postmortem: the old bench measured all
three metrics in ONE process and buffered every JSON line until the
end, so when the expensive real-panel metric blew the driver's window
(rc=124) even the successfully-measured numbers were lost.  This
version is a thin orchestrator that never touches the device itself:

  * every metric runs in its own SUBPROCESS under a hard `timeout`
    (fresh device context, tables freed on exit, a hang is contained);
  * each worker prints its JSON line the moment the metric is measured,
    and the orchestrator re-prints it immediately (flushed) — a timeout
    anywhere later can no longer lose an already-measured number;
  * metrics run cheapest-first: PRIMARY toy-panel funnel, then the
    115M-key scale funnel, then the real-motif panel (the most
    compile-hungry) last;
  * a global wall-clock budget (DTK_BENCH_BUDGET, default 1000 s) is
    split across metrics; a metric that does not fit is SKIPPED with a
    loud stderr note, never allowed to kill the run;
  * the PRIMARY metric line is re-emitted as the very last stdout line
    so a last-line parser still captures the headline.

Metrics:
  1. wgs_funnel_reads_per_sec_per_chip   — PRIMARY: 512-locus toy-panel
     funnel (comparable across rounds r01+), tools/bench_panel_funnel.py
  2. wgs_funnel_scale115M_reads_per_sec  — FULL production funnel at the
     80k-locus / 115M-key index, real hg38 chr12 background
     (tools/bench_scale_funnel.py)
  3. wgs_funnel_real_panel_reads_per_sec — real-VNTR-motif panel with
     heavy cross-locus k-mer sharing (tools/bench_panel_funnel.py)

Workers pre-pay compiles via the persistent XLA cache (build/jaxcache),
warmed during the build session; each worker also receives a soft
deadline (DTK_PF_DEADLINE_TS) so it emits with fewer steady passes
rather than being hard-killed with nothing.

Baseline: the reference `danbing-tk align` genotypes one 30x SRS sample
in ~12 CPU-hours (/root/reference/README.md:42) = ~14.35k reads/s per
CPU core-equivalent.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

T0 = time.time()
BUDGET = float(os.environ.get("DTK_BENCH_BUDGET", 1000))


def remaining():
    return BUDGET - (time.time() - T0)


def quiesce(tol: float = 1.0, timeout: float = 240) -> bool:
    """Refuse to measure on a contended host: wait (up to `timeout` s)
    for 1-min loadavg <= tol (round-3 lesson: a concurrent 34 GB index
    build corrupted the official number by 45%)."""
    if "DTK_QUIESCE_TOL" in os.environ or "DTK_QUIESCE_TIMEOUT" in os.environ:
        # never let a stale override silently neuter the guard
        print("# quiesce: tol/timeout OVERRIDDEN via DTK_QUIESCE_* — "
              "numbers from this run are NOT official", file=sys.stderr,
              flush=True)
    tol = float(os.environ.get("DTK_QUIESCE_TOL", tol))
    timeout = float(os.environ.get("DTK_QUIESCE_TIMEOUT", timeout))
    t0 = time.time()
    while True:
        load1 = os.getloadavg()[0]
        if load1 <= tol:
            if time.time() - t0 > 1:
                print(f"# quiesce: loadavg {load1:.2f} after "
                      f"{time.time()-t0:.0f}s wait", file=sys.stderr)
            return True
        if time.time() - t0 >= timeout:
            print(f"# WARNING: host still contended (loadavg {load1:.2f}"
                  f" > {tol}) after {timeout:.0f}s — numbers may be "
                  f"corrupted by host contention",
                  file=sys.stderr, flush=True)
            return False
        print(f"# quiesce: loadavg {load1:.2f} > {tol}, waiting...",
              file=sys.stderr, flush=True)
        time.sleep(15)


def run_worker(tag, script, env_extra, soft_budget, grace=120):
    """Run one metric worker under a hard timeout; stream its stderr
    through live (the driver tail is the only progress record); parse
    every JSON line on its stdout.  Returns the list of parsed dicts
    (empty on failure) — NEVER raises."""
    env = dict(os.environ)
    env.update(env_extra)
    env["DTK_PF_DEADLINE_TS"] = str(time.time() + soft_budget)
    print(f"# [{tag}] starting (soft budget {soft_budget:.0f}s, "
          f"{remaining():.0f}s total left)", file=sys.stderr, flush=True)
    t0 = time.time()
    try:
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", script)],
            env=env, stdout=subprocess.PIPE, stderr=None, text=True,
            timeout=soft_budget + grace, cwd=ROOT)
        out, rc = r.stdout or "", r.returncode
    except subprocess.TimeoutExpired as e:
        out = e.stdout or ""
        if isinstance(out, bytes):
            out = out.decode("utf-8", "replace")
        rc = 124
        print(f"# [{tag}] HARD TIMEOUT after {time.time()-t0:.0f}s — "
              f"killed; any JSON already printed is kept",
              file=sys.stderr, flush=True)
    except Exception as e:  # never let one metric kill the bench
        out, rc = "", -1
        print(f"# [{tag}] FAILED to run: {e}", file=sys.stderr, flush=True)
    if rc not in (0, 124):
        print(f"# [{tag}] exited rc={rc} ({time.time()-t0:.0f}s)",
              file=sys.stderr, flush=True)
    parsed = []
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                parsed.append(json.loads(line))
            except ValueError:
                pass
    return parsed


def emit(m):
    print(json.dumps(m), flush=True)


def main():
    quiesce()

    emitted_primary = None

    # ---- metric 1 (PRIMARY): toy-panel funnel — must land ----
    budget = min(480.0, max(remaining() - 120, 180))
    for m in run_worker("primary toy funnel", "bench_panel_funnel.py",
                        {"DTK_PF_PANEL": "synthetic"}, budget):
        if m.get("metric") == "wgs_funnel_reads_per_sec_per_chip":
            emitted_primary = m
            emit(m)

    # ---- metric 2: 115M-key scale funnel ----
    force = os.environ.get("DTK_BENCH_SCALE")
    cache = os.path.join(ROOT, "build", "scale_80000_1500_9_1_v4.npz")
    if force == "0" or (not os.path.exists(cache) and force != "1"):
        print(f"# scale funnel skipped: no cached index ({cache}); "
              f"set DTK_BENCH_SCALE=1 to build it (~20 min host)",
              file=sys.stderr, flush=True)
    elif remaining() < 240:
        print(f"# scale funnel skipped: only {remaining():.0f}s of the "
              f"{BUDGET:.0f}s budget left", file=sys.stderr, flush=True)
    else:
        env = {"DTK_SF_BG": os.environ.get("DTK_SF_BG", "real"),
               "DTK_SF_PAIRS": os.environ.get("DTK_SF_PAIRS", "2000000"),
               "DTK_SF_STEADY": os.environ.get("DTK_SF_STEADY", "5"),
               # at scale the retry tier IS the right design: overflow
               # pairs are a small share, and a cached E=4096 device
               # tier resolves them far cheaper than the host referee;
               # the opposite holds on the small real-motif panel, where
               # most survivors overflow and the NATIVE referee pool
               # wins)
               "DTK_SF_RETRY": os.environ.get("DTK_SF_RETRY", "4096"),
               "DTK_PREFILTER_MULT":
                   os.environ.get("DTK_PREFILTER_MULT", "16")}
        budget = min(600.0, max(remaining() - 200, 240))
        for m in run_worker("scale funnel", "bench_scale_funnel.py",
                            env, budget):
            if m.get("metric") == "scale_funnel_reads_per_sec":
                out = {
                    "metric": "wgs_funnel_scale115M_reads_per_sec",
                    "value": m["value"], "unit": m["unit"],
                    "vs_baseline": m["vs_baseline"],
                    "provenance": "80k-locus/115M-key index, 2M PE "
                                  "pairs, 5% TR, real hg38 chr12 "
                                  "background, 0.2%/base errors, retry "
                                  "ladder E=4096",
                }
                for k in ("spread", "passes", "contaminated"):
                    if k in m:
                        out[k] = m[k]
                emit(out)
            elif m.get("metric") == "scale_funnel_ckpt_overhead":
                emit(m)

    # ---- metric 3: real-motif panel funnel (most compile-hungry) ----
    if os.environ.get("DTK_BENCH_REAL", "1") == "0":
        pass
    elif remaining() < 180:
        print(f"# real-panel funnel skipped: only {remaining():.0f}s of "
              f"the {BUDGET:.0f}s budget left", file=sys.stderr,
              flush=True)
    else:
        budget = max(remaining() - 60, 150)
        for m in run_worker("real-panel funnel", "bench_panel_funnel.py",
                            {"DTK_PF_PANEL": "real"}, budget):
            if m.get("metric") == "wgs_funnel_real_panel_reads_per_sec":
                emit(m)

    # ---- the PRIMARY line goes last for last-line parsers ----
    if emitted_primary is not None:
        emit(emitted_primary)
    else:
        print("# WARNING: primary metric did not land this run",
              file=sys.stderr, flush=True)
        sys.exit(3)


if __name__ == "__main__":
    main()
