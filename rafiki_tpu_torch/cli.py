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
- ``stack start|stop|status`` (``admin/stack.py``), with the JAX
  options plus ``--device cpu``.

``doctor``, ``backup`` and ``lint`` are parsed as in JAX and raise
``NotPorted`` naming themselves.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

#: subcommands the JAX CLI has and the port does not yet
NOT_PORTED = {
    "doctor": "the environment and workdir audit (admin/doctor.py)",
    "backup": "the meta store snapshot (MetaStore.backup)",
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

    p_doc = sub.add_parser("doctor", help="not ported: " +
                           NOT_PORTED["doctor"])
    p_doc.add_argument("--workdir", default=None)
    p_doc.add_argument("--json", action="store_true", dest="as_json")
    p_backup = sub.add_parser("backup", help="not ported: " +
                              NOT_PORTED["backup"])
    p_backup.add_argument("out")
    p_backup.add_argument("--workdir", default="./rafiki_stack")
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
                         help="not ported: a clean-slate boot")
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
