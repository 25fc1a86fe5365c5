"""``key:value`` config file parser (mirrors ``rgbd_recon_tpu/io/configurator.py``).

Format-compatible with the reference's Configurator singleton
(framework/io/configurator.cpp:8-52): whitespace is stripped, ``#`` lines are
comments, type inference is all-digits -> uint, all-alpha -> bool
("true"/anything-else), otherwise float; comma lists -> uint lists. The
key set the client reads is kinect_client.cpp:292-315.
"""
from __future__ import annotations


class Configurator:
    _instance: "Configurator | None" = None

    def __init__(self):
        self.bools: dict[str, bool] = {}
        self.floats: dict[str, float] = {}
        self.uints: dict[str, int] = {}
        self.lists: dict[str, list[int]] = {}

    @classmethod
    def instance(cls) -> "Configurator":
        """Singleton accessor (≙ the reference's global ``configurator()``,
        io/configurator.hpp:8)."""
        if cls._instance is None:
            cls._instance = Configurator()
        return cls._instance

    def read(self, filename: str) -> "Configurator":
        with open(filename) as f:
            for line in f:
                line = "".join(line.split())  # strip ALL whitespace, like the C++
                if ":" not in line:
                    continue
                name, _, val = line.partition(":")
                if len(name) < 2 or name.startswith("#"):
                    continue
                if "," in val:
                    self.lists[name] = [int(float(v or "0")) for v in val.split(",")]
                elif val.isdigit():
                    self.uints[name] = int(val)
                elif val.isalpha():
                    self.bools[name] = val == "true"
                else:
                    try:
                        self.floats[name] = float(val)
                    except ValueError:
                        self.floats[name] = 0.0
        return self

    def get_bool(self, name: str, default: bool = False) -> bool:
        return self.bools.get(name, default)

    def get_float(self, name: str, default: float = 0.0) -> float:
        return self.floats.get(name, default)

    def get_uint(self, name: str, default: int = 0) -> int:
        return self.uints.get(name, default)

    def get_list(self, name: str, default=None) -> list[int]:
        return self.lists.get(name, default if default is not None else [])

    def get(self, name: str, default=None):
        for table in (self.bools, self.uints, self.floats, self.lists):
            if name in table:
                return table[name]
        return default

    def print(self) -> None:
        for label, table in (
            ("floats", self.floats), ("uints", self.uints),
            ("bools", self.bools), ("lists", self.lists),
        ):
            print(label)
            for k, v in table.items():
                print(f"{k}: {v}")
