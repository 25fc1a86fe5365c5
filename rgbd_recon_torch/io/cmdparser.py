"""getopt-style CLI parser (mirrors ``rgbd_recon_tpu/io/cmdparser.py``).

API-compatible port of the reference's CMDParser (framework/io/CMDParser.h:
10-36): typed multi-value short options + positional args; the client wires
``-s -d -w -l -r -m -c -f -p`` (kinect_client.cpp:866-930).
"""
from __future__ import annotations


class CMDParser:
    def __init__(self, arguments: str = ""):
        self._arguments = arguments
        self._opts: dict[str, list[str]] = {}
        self._num_values: dict[str, int] = {}
        self._help: dict[str, str] = {}
        self._set: set[str] = set()
        self.args: list[str] = []

    def add_opt(self, opt: str, num_values: int, optlong: str, help: str = ""):
        self._opts[opt] = []
        self._num_values[opt] = num_values
        self._help[opt] = f"-{opt} ({optlong}): {help}"

    def show_help(self) -> str:
        lines = [f"usage: <prog> [options] {self._arguments}"]
        lines += sorted(self._help.values())
        return "\n".join(lines)

    def init(self, argv: list[str]) -> None:
        i = 0
        while i < len(argv):
            tok = argv[i]
            if tok.startswith("-") and len(tok) > 1 and tok[1:] in self._opts:
                opt = tok[1:]
                self._set.add(opt)
                n = self._num_values[opt]
                if n < 0:  # variadic: consume until next option
                    vals = []
                    while i + 1 < len(argv) and not (
                        argv[i + 1].startswith("-") and argv[i + 1][1:] in self._opts
                    ):
                        vals.append(argv[i + 1])
                        i += 1
                    self._opts[opt] = vals
                else:
                    self._opts[opt] = argv[i + 1 : i + 1 + n]
                    i += n
            else:
                self.args.append(tok)
            i += 1

    def is_opt_set(self, opt: str) -> bool:
        return opt in self._set

    def get_opts_int(self, opt: str) -> list[int]:
        return [int(v) for v in self._opts[opt]]

    def get_opts_float(self, opt: str) -> list[float]:
        return [float(v) for v in self._opts[opt]]

    def get_opts_string(self, opt: str) -> list[str]:
        return list(self._opts[opt])
