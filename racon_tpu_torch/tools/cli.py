"""raconx-torch-tools — umbrella CLI for the port's companion tools (a
copy of racon_tpu/tools/cli.py).

    raconx-torch-tools subsample|split ...   rampler equivalent
    raconx-torch-tools preprocess ...        racon_preprocess equivalent
    raconx-torch-tools wrapper ...           racon_wrapper equivalent, on
                                             the port's Polisher (auto =
                                             cuda: on the card)
"""

from __future__ import annotations

import sys

from . import preprocess, rampler, wrapper

USAGE = """usage: raconx-torch-tools <tool> [args ...]

    tools:
        subsample / split   sequence sampler (rampler)
        preprocess          paired-end FASTQ header uniquifier
        wrapper             subsample/split + polish pipeline wrapper
"""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE, end="")
        return 0 if argv else 1
    tool, rest = argv[0], argv[1:]
    if tool in ("subsample", "split"):
        return rampler.main([tool] + rest)
    if tool == "rampler":
        return rampler.main(rest)
    if tool == "preprocess":
        return preprocess.main(rest)
    if tool == "wrapper":
        return wrapper.main(rest)
    sys.stderr.write(f"[raconx-torch-tools] error: unknown tool '{tool}'\n")
    print(USAGE, end="")
    return 1


if __name__ == "__main__":
    sys.exit(main())
