"""Canonical N-sweep: N in {8..1024} across three structure classes.

The reference supports N up to 65,535 through 8-column output slabs
(src/sextans-host.cpp:223; src/sextans.cpp:52-60) and its throughput is
N-independent by construction. This sweep measures the engines across
output widths on the reference's canonical matrix, the densest FEM
stand-in, and the adversarial power-law class, on the GPU only.

Rows use the same protocol/schema as the suite (run_one: candidate race,
f64 oracle + ulp column).

Usage: python benchmarks/nsweep.py [--out nsweep.json]
    [--matrices nasa4704 pdb1HYS_like webgraph_like] [--ns 8 16 ... 1024]
"""
import argparse
import json
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(m):
    print(m, file=sys.stderr, flush=True)


def resume_state(prev_doc, redo=()):
    """Measured cells kept from a previous (timeout-cut) sweep document:
    returns (rows_kept, done_keys). Error rows are dropped so the resumed
    sweep retries them; measured cells are final and never re-raced —
    except cells named in ``redo`` ({(matrix, n)}), which are dropped for
    a fresh race (for suspect samples, e.g. a contended-window outlier
    sitting far below its own neighbors).

    Kept rows are stamped with the PREVIOUS document's session (unless they
    already carry one): the resumed sweep rewrites the file under its own
    doc-level session header, which would otherwise mislabel the kept
    measurements' device/timestamp provenance."""
    prev_session = prev_doc.get("session")
    rows = [
        r for r in prev_doc.get("results", [])
        if "gflops" in r and (r["matrix"], r["n"]) not in set(redo)
    ]
    if prev_session:
        for r in rows:
            r.setdefault("session", prev_session)
    return rows, {(r["matrix"], r["n"]) for r in rows}


def parse_redo(specs):
    """--redo 'matrix:N' [...] -> {(matrix, n)}."""
    out = set()
    for s in specs or ():
        mat, _, n = s.rpartition(":")
        out.add((mat, int(n)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--ns", type=int, nargs="+",
                    default=[8, 16, 32, 64, 128, 256, 512, 1024])
    ap.add_argument("--matrices", nargs="+",
                    default=["nasa4704", "pdb1HYS_like", "webgraph_like"])
    ap.add_argument("--tuned-configs", default=None)
    ap.add_argument("--deadline-ts", type=float, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="keep rows already in --out and skip their "
                         "(matrix, N) cells — a timeout-cut sweep "
                         "continues instead of overwriting")
    ap.add_argument("--redo", nargs="*", default=None, metavar="MATRIX:N",
                    help="with --resume: drop these measured cells and "
                         "re-race them")
    args = ap.parse_args(argv)

    import jax

    from benchmarks.matrices import suite as suite_gens
    from benchmarks.suite import _gen_cached, run_one
    from sextans_tpu.format.pack_cache import PackCache
    from sextans_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    log(f"devices: {jax.devices()}")
    if dev.platform != "gpu":
        log(f"no GPU (platform {dev.platform!r}): the sweep measures on the "
            "GPU only")
        return 2
    gens = suite_gens("full")
    session = {
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "sweep": "nsweep",
    }

    store = None
    if args.tuned_configs:
        from sextans_tpu.utils.autotune import ConfigStore

        store = ConfigStore(args.tuned_configs)

    pack_cache = PackCache()
    rows = []
    done = set()
    if args.resume and args.out and Path(args.out).exists():
        rows, done = resume_state(
            json.loads(Path(args.out).read_text()), parse_redo(args.redo)
        )
        log(f"resume: {len(done)} measured cells kept from {args.out}")
    for name in args.matrices:
        if name not in gens:
            log(f"unknown matrix {name}; skipping")
            continue
        if done and all((name, n) in done for n in args.ns):
            log(f"== {name}: all cells done; skipping ==")
            continue
        coo = _gen_cached(name, gens[name])
        log(f"== {name}: {coo.shape} nnz={coo.nnz} ==")
        for n in args.ns:
            if (name, n) in done:
                continue
            if args.deadline_ts and time.time() > args.deadline_ts:
                log("deadline reached")
                break
            try:
                rec = run_one(
                    name, coo, n, "auto", True, store=store,
                    pack_cache=pack_cache,
                )
            except Exception as e:
                rec = {"matrix": name, "n": n, "error": repr(e)[:200]}
            rows.append(rec)
            log(f"  N={n}: {rec.get('gflops', '-')} GFLOPS "
                f"(fmt={rec.get('fmt')}, verify={rec.get('verify')}, "
                f"ulp={rec.get('max_abs_vs_f64_ulp')})")
            if args.out:
                Path(args.out).write_text(
                    json.dumps({"session": session, "results": rows}, indent=1)
                )
            if "RESOURCE_EXHAUSTED" in str(rec.get("error", "")):
                # a device OOM can leave the client unusable: every later
                # row would be garbage — publish what exists and end
                log("device OOM: ending the sweep")
                doc = {"session": session, "results": rows}
                print(json.dumps(doc, indent=1))
                if args.out:
                    Path(args.out).write_text(json.dumps(doc, indent=1))
                return 0

    doc = {"session": session, "results": rows}
    print(json.dumps(doc, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
