"""CLI: ``python -m paddle_tpu_torch.analysis.kernels <paths>``.

Checks the port's kernel modules with rules CK200-CK209 and prints each
declared launch's resource sheet after the findings; exits 1 when an
error-severity finding remains after filtering and the allowlist
(``paddle_tpu_torch/analysis/kernels/allowlist.txt``, found by walking up
from the analyzed paths), 0 otherwise, 2 on a usage error. Runs every
plane on the card; ``--device cpu`` runs the declaration and source
planes alone. Without a card (and without ``--device cpu``) it raises.
"""

from __future__ import annotations

import sys

from ..cli import run_lint_cli
from . import ALLOWLIST_NAME, RULES, collect


def main(argv=None) -> int:
    state = {"sheets": []}

    def add_arguments(ap):
        ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="cuda (the default: every plane) or cpu (the "
                             "declaration and source planes)")

    def analyze(paths, args):
        findings, sheets = collect(paths, device=args.device)
        state["sheets"] = sheets
        return findings

    def payload_extra(args):
        return {"resource_sheets": [s.to_dict() for s in state["sheets"]]}

    def text_extra(args):
        if not state["sheets"]:
            return None
        return "\n".join(["resource sheets:"] + [
            "  " + s.line_text() for s in state["sheets"]])

    return run_lint_cli(
        argv,
        prog="python -m paddle_tpu_torch.analysis.kernels",
        description="CUDA kernel analyzer: launch limits, output coverage, "
                    "overlap and bounds over the kernels' ck_examples() "
                    "declarations, ptxas resource sheets, profiled and "
                    "guard-band launches on the card, and the launch "
                    "discipline of the wrappers' source.",
        rules=RULES,
        analyze=analyze,
        allowlist_name=ALLOWLIST_NAME,
        select_example="CK200,CK205",
        positional_help="kernel .py files or directories "
                        "(e.g. paddle_tpu_torch/ops/kernels/)",
        add_arguments=add_arguments,
        payload_extra=payload_extra,
        text_extra=text_extra)


if __name__ == "__main__":
    sys.exit(main())
