"""The port's command-line reference, generated from its argument parser.

Counterpart of the JAX package's ``tools/gen_cli_docs.py``, which writes
``docs/command_line.md`` for ``badslam_tpu``; this one writes the table of
``badslam_torch``'s flags to the path given, or prints it:

    python -m badslam_torch.tools.gen_cli_docs [OUT.md]
"""

from __future__ import annotations

import argparse
import sys


def cli_docs() -> str:
    """The markdown flag table of ``python -m badslam_torch``."""
    from badslam_torch.cli import build_parser

    p = build_parser()
    lines = [
        "# badslam_torch command line",
        "",
        "Generated by `python -m badslam_torch.tools.gen_cli_docs` — do not edit by hand.",
        "",
        "```",
        "python -m badslam_torch <dataset_dir> [options]",
        "python -m badslam_torch --live dir:<path>|tcp:<port> [options]",
        "```",
        "",
        "| flag | default | help |",
        "|---|---|---|",
    ]
    for a in p._actions:
        if not a.option_strings:
            name = f"`{a.dest}`"
        else:
            name = "`" + "`, `".join(a.option_strings) + "`"
        default = "" if a.default in (None, False) else repr(a.default)
        help_text = (a.help or "").replace("|", "\\|").replace("\n", " ")
        lines.append(f"| {name} | {default} | {help_text} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("output", nargs="?", default=None,
                   help="write the table to this path (default: print it)")
    args = p.parse_args(argv)
    text = cli_docs()
    if args.output is None:
        sys.stdout.write(text)
    else:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output} ({text.count(chr(10) + '| `')} flags)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
