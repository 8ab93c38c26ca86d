"""The port's command line: ``python -m rafiki_tpu_torch.cli``.

The port's own copy of ``rafiki_tpu/cli.py``'s ``main``, with its
subcommands:

- ``version``;
- ``tune <template> <train> <val> [--trials N] [--advisor A]
  [--profile DIR] [--device cpu]``: ``tune_model`` over a zoo template
  (``models/__init__.py``), printing ``best_score=… best_knobs=…``. It
  runs on the CUDA card; ``--device cpu`` (the port's counterpart of
  ``RAFIKI_JAX_PLATFORM=cpu``) is the only way onto the CPU. ``--profile``
  writes a ``torch.profiler`` trace per trial;
- ``bpe-train <corpus> <out> [--vocab N]``: a byte-level BPE artifact
  (a ``.jsonl`` corpus contributes its rows' ``text`` fields);
- ``stack start|stop|status [--cold]`` (``admin/stack.py``), with the
  JAX options plus ``--device cpu``;
- ``doctor``: the environment report (the JAX rows; where JAX checks its
  backend, one tiny matmul on the CUDA card and the card's name), and
  with ``--workdir W [--json]`` the read-only drift audit of a stack's
  workdir (``admin/doctor.py``); exit 0 when all is well;
- ``backup <out> [--workdir W]``: an online snapshot of the stack's
  MetaStore, opened read-only.

``lint`` is parsed as in JAX and raises ``NotPorted`` naming itself.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

#: subcommands the JAX CLI has and the port does not yet
NOT_PORTED = {
    "lint": "the static analyzer (rafiki_tpu/analysis/)",
}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rafiki_tpu_torch.cli",
        description="AutoML train-and-serve framework, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="cmd")

    sub.add_parser("version", help="print version")

    p_tune = sub.add_parser(
        "tune", help="local tuning loop over a zoo template (dev use)")
    p_tune.add_argument("template",
                        help="zoo template name, e.g. JaxFeedForward")
    p_tune.add_argument("train_dataset")
    p_tune.add_argument("val_dataset")
    p_tune.add_argument("--trials", type=int, default=5)
    p_tune.add_argument("--advisor", default="auto")
    p_tune.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace per trial to "
                             "DIR")
    p_tune.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="where the trials run (default: the CUDA "
                             "card, which must be present)")

    p_bpe = sub.add_parser(
        "bpe-train",
        help="train a byte-level BPE tokenizer artifact from a corpus "
             "(for LlamaLoRA's tokenizer_path knob)")
    p_bpe.add_argument("corpus", help="UTF-8 text file (or .jsonl with "
                                      "'text' fields) to learn merges from")
    p_bpe.add_argument("out", help="artifact path, e.g. bpe.json")
    p_bpe.add_argument("--vocab", type=int, default=8192,
                       help="target vocab size (specials + 256 bytes + "
                            "merges)")

    p_doc = sub.add_parser(
        "doctor",
        help="check the environment (the CUDA card, native artifacts) "
             "and print a health report; with --workdir, audit a stack "
             "workdir instead (MetaStore rows vs live pids vs slots vs "
             "obs ports: a drift report)")
    p_doc.add_argument("--workdir", default=None,
                       help="stack workdir to audit (read-only; safe "
                            "against a live stack)")
    p_doc.add_argument("--json", action="store_true", dest="as_json",
                       help="emit the audit as JSON (with --workdir)")
    p_backup = sub.add_parser(
        "backup",
        help="snapshot a stack's MetaStore (SQLite online backup; "
             "consistent under a live admin): run before risky ops")
    p_backup.add_argument("out", help="destination file for the snapshot")
    p_backup.add_argument("--workdir", default="./rafiki_stack",
                          help="stack workdir holding meta.db")
    p_lint = sub.add_parser("lint", help="not ported: " +
                            NOT_PORTED["lint"])
    p_lint.add_argument("paths", nargs="*")

    p_stack = sub.add_parser("stack",
                             help="manage the full local service stack")
    p_stack.add_argument("action", choices=["start", "stop", "status"])
    p_stack.add_argument("--workdir", default="./rafiki_stack")
    p_stack.add_argument("--port", type=int, default=3000,
                         help="admin REST port")
    p_stack.add_argument("--workers", type=int, default=1,
                         help="train workers per job when the budget "
                              "names no WORKER_COUNT/GPU_COUNT")
    p_stack.add_argument("--slot-size", dest="slot_size", type=int,
                         default=1, help="cards per trial slot")
    p_stack.add_argument("--cold", action="store_true",
                         help="start: kill every recorded survivor "
                              "instead of adopting it (a clean-slate "
                              "boot for when the previous stack's state "
                              "is not to be trusted)")
    p_stack.add_argument("--device", choices=["cuda", "cpu"],
                         default="cuda",
                         help="start: a stack over the CUDA cards "
                              "(default) or a CPU stack")

    args = parser.parse_args(argv)
    if args.cmd is None:
        parser.print_help()
        return 2
    if args.cmd in NOT_PORTED:
        from rafiki_tpu_torch.serving.decode_engine import NotPorted

        raise NotPorted(f"the {args.cmd!r} command "
                        f"({NOT_PORTED[args.cmd]}) is not ported yet")
    if args.cmd == "doctor":
        if args.workdir:
            return _doctor_workdir(args.workdir, args.as_json)
        return _doctor()
    if args.cmd == "backup":
        return _backup(args.out, args.workdir)
    if args.cmd == "version":
        from rafiki_tpu_torch import __version__

        print(__version__)
        return 0
    if args.cmd == "tune":
        from rafiki_tpu_torch.model.dev import tune_model
        from rafiki_tpu_torch.models import get_model_template
        from rafiki_tpu_torch.utils.device import resolve_device

        device = resolve_device(args.device)  # no card: raises here
        result = tune_model(get_model_template(args.template),
                            args.train_dataset, args.val_dataset,
                            total_trials=args.trials,
                            advisor_type=args.advisor,
                            profile_dir=args.profile, device=device)
        print(f"best_score={result.best_score:.4f} "
              f"best_knobs={result.best_knobs}")
        return 0
    if args.cmd == "bpe-train":
        return _bpe_train(args)
    from rafiki_tpu_torch.admin.stack import stack_command

    return stack_command(args)


def _doctor_workdir(workdir: str, as_json: bool) -> int:
    """Drift audit of a stack workdir; exit 0 iff no drift. Pure /proc
    and sqlite reads: it works on a host whose card is wedged."""
    import json

    from rafiki_tpu_torch.admin.doctor import audit_workdir, render_text

    report = audit_workdir(workdir)
    print(json.dumps(report, indent=2) if as_json else render_text(report))
    return 0 if report["ok"] else 1


def _backup(out: str, workdir: str) -> int:
    """Online snapshot of ``workdir/meta.db`` to ``out``; the store is
    opened read-only, so the backup never migrates or writes it."""
    import json
    import os

    from rafiki_tpu_torch.store.meta_store import MetaStore

    db = os.path.join(workdir, "meta.db")
    if not os.path.exists(db):
        print(f"no MetaStore at {db}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True,
                      **MetaStore(db, read_only=True).backup(out)}))
    return 0


def _doctor() -> int:
    """The environment report: one row a check with its mark; exit 0
    iff every load-bearing check passes. It claims the card for one
    tiny matmul and builds or launches no port kernel."""
    ok = True

    def row(good: bool, label: str, detail: str = "",
            fatal: bool = True) -> None:
        nonlocal ok
        mark = "ok " if good else ("FAIL" if fatal else "warn")
        print(f"[{mark}] {label}" + (f": {detail}" if detail else ""))
        if fatal and not good:
            ok = False

    from rafiki_tpu_torch import __version__

    row(True, "rafiki_tpu_torch", __version__)
    try:
        import time

        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(f"torch {torch.__version__}: no CUDA "
                               "device is available")
        name = torch.cuda.get_device_name(0)
        row(True, "cuda device", f"{name}, {torch.cuda.device_count()} "
                                 f"card(s), torch {torch.__version__}, "
                                 f"CUDA {torch.version.cuda}")
        t0 = time.perf_counter()
        x = torch.ones((256, 256), dtype=torch.bfloat16, device="cuda")
        (x @ x).sum().item()
        row(True, "device matmul",
            f"bf16 256x256 in {time.perf_counter() - t0:.2f}s (first "
            "call includes the context's start)")
    except Exception as e:  # the report is the product
        row(False, "cuda device", str(e))
    try:
        from rafiki_tpu_torch.native.client import ensure_built

        row(True, "native kv server", str(ensure_built()))
        row(True, "native bpe encoder",
            str(ensure_built(target="librbpe.so")))
    except Exception as e:
        row(False, "native build", str(e), fatal=False)
    try:
        from rafiki_tpu_torch.data.bpe import ByteBPETokenizer

        tok = ByteBPETokenizer.train(["doctor check"] * 4, vocab_size=270)
        row(tok.decode(tok.encode_ids("doctor")) == "doctor",
            "bpe round-trip",
            "native" if tok._native is not None else "python fallback")
    except Exception as e:
        row(False, "bpe round-trip", str(e))
    import os

    # the port's counterpart of JAX's compile cache: where nvcc and g++
    # put what they build at first use
    from rafiki_tpu_torch.ops._build import BUILD_DIR

    probe = BUILD_DIR
    while not probe.is_dir() and probe.parent != probe:
        probe = probe.parent
    row(os.access(probe, os.W_OK), "kernel build dir", str(BUILD_DIR),
        fatal=False)
    if os.environ.get("RAFIKI_PG_URL", ""):
        row(False, "postgres", "RAFIKI_PG_URL is set, but the port's "
                               "MetaStore has no PostgreSQL backend",
            fatal=False)
    else:
        row(True, "postgres",
            "not configured (RAFIKI_PG_URL unset; sqlite is the default "
            "MetaStore backing)")
    print("all checks passed" if ok else "SOME CHECKS FAILED")
    return 0 if ok else 1


def _bpe_train(args: argparse.Namespace) -> int:
    import json

    from rafiki_tpu_torch.data.bpe import ByteBPETokenizer

    is_jsonl = args.corpus.endswith(".jsonl")

    def lines():
        # format by extension, not per-line sniffing: a plain-text corpus
        # may hold JSON-looking lines
        with open(args.corpus, encoding="utf-8") as f:
            for line in f:
                if not is_jsonl:
                    yield line
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                text = rec.get("text") if isinstance(rec, dict) else None
                if isinstance(text, str):  # skip metadata/null rows
                    yield text

    tok = ByteBPETokenizer.train(lines(), vocab_size=args.vocab)
    tok.save(args.out)
    print(f"vocab_size={tok.vocab_size} merges={len(tok.merges)} "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
