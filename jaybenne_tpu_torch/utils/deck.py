"""Parameter-input ("deck") parser.

A copy of ``jaybenne_tpu/utils/deck.py`` (importing that one would pull in jax).
Reads the same ``<block> key = value`` input-deck format the reference consumes via
Parthenon's ``ParameterInput`` (see e.g. ``inputs/stepdiff.in`` and the harness
mutation logic at ``tst/regression_test.py:85-145``):

  * blocks open with ``<blockname>`` on their own line,
  * entries are ``key = value`` with ``#`` comments stripped,
  * a trailing ``&`` continues a value onto the next line,
  * later duplicate assignments override earlier ones,
  * unknown ("dead") keys are parse-tolerated (the reference tolerates
    ``transport_model``, ``tracking_algo``, ``specific_heat`` etc.).

The :class:`Deck` object exposes typed ``get_*``/``get_or_add_*`` accessors mirroring
Parthenon's ``GetString/GetReal/GetOrAdd*`` semantics, plus path-based mutation
(``set("parthenon/mesh/nx1", 128)``) used by the regression harness.
"""

from __future__ import annotations

import re
from collections import OrderedDict


_BLOCK_RE = re.compile(r"^<\s*([^>]+?)\s*>$")


class DeckError(Exception):
    pass


def _strip_comment(line: str) -> str:
    # '#' begins a comment anywhere on the line
    idx = line.find("#")
    if idx >= 0:
        line = line[:idx]
    return line.strip()


class Deck:
    """An ordered mapping of ``block -> {key -> raw string value}``."""

    def __init__(self) -> None:
        self.blocks: "OrderedDict[str, OrderedDict[str, str]]" = OrderedDict()

    # ------------------------------------------------------------------ parsing
    @classmethod
    def parse(cls, text: str) -> "Deck":
        deck = cls()
        current = None
        pending_key = None
        pending_val: list[str] = []

        for raw in text.splitlines():
            line = _strip_comment(raw)
            if not line:
                continue

            if pending_key is not None:
                # continuation of a '&'-terminated value
                cont = line
                more = cont.endswith("&")
                if more:
                    cont = cont[:-1].strip()
                pending_val.append(cont)
                if not more:
                    deck._assign(current, pending_key, " ".join(pending_val))
                    pending_key, pending_val = None, []
                continue

            m = _BLOCK_RE.match(line)
            if m:
                current = m.group(1)
                deck.blocks.setdefault(current, OrderedDict())
                continue

            if "=" in line:
                if current is None:
                    raise DeckError(f"key=value outside any <block>: {line!r}")
                key, val = line.split("=", 1)
                key, val = key.strip(), val.strip()
                if val.endswith("&"):
                    pending_key = key
                    pending_val = [val[:-1].strip()]
                else:
                    deck._assign(current, key, val)
            else:
                raise DeckError(f"unparseable deck line: {raw!r}")

        if pending_key is not None:
            raise DeckError(f"dangling continuation for key {pending_key!r}")
        return deck

    @classmethod
    def from_file(cls, path) -> "Deck":
        with open(path) as f:
            return cls.parse(f.read())

    def _assign(self, block: str, key: str, value: str) -> None:
        self.blocks.setdefault(block, OrderedDict())[key] = value

    # ------------------------------------------------------------------ access
    def has(self, block: str, key: str) -> bool:
        return block in self.blocks and key in self.blocks[block]

    def _raw(self, block: str, key: str) -> str:
        try:
            return self.blocks[block][key]
        except KeyError:
            raise DeckError(f"missing required parameter <{block}> {key}") from None

    def get_str(self, block: str, key: str) -> str:
        return self._raw(block, key)

    def get_real(self, block: str, key: str) -> float:
        return float(self._raw(block, key))

    def get_int(self, block: str, key: str) -> int:
        return int(float(self._raw(block, key)))

    def get_bool(self, block: str, key: str) -> bool:
        v = self._raw(block, key).lower()
        if v in ("true", "1", "yes", "on"):
            return True
        if v in ("false", "0", "no", "off"):
            return False
        raise DeckError(f"non-boolean value for <{block}> {key}: {v!r}")

    def get_or_add_str(self, block: str, key: str, default: str) -> str:
        if not self.has(block, key):
            self._assign(block, key, default)
        return self.get_str(block, key)

    def get_or_add_real(self, block: str, key: str, default: float) -> float:
        if not self.has(block, key):
            self._assign(block, key, repr(float(default)))
        return self.get_real(block, key)

    def get_or_add_int(self, block: str, key: str, default: int) -> int:
        if not self.has(block, key):
            self._assign(block, key, str(int(default)))
        return self.get_int(block, key)

    def get_or_add_bool(self, block: str, key: str, default: bool) -> bool:
        if not self.has(block, key):
            self._assign(block, key, "true" if default else "false")
        return self.get_bool(block, key)

    def get_list(self, block: str, key: str) -> list[str]:
        """Comma-separated list value (e.g. output variables)."""
        return [s.strip() for s in self._raw(block, key).split(",") if s.strip()]

    # ------------------------------------------------------------------ mutation
    def set(self, path: str, value) -> None:
        """Set ``"block/key"`` (or ``"block/sub/key"``: all but the last segment form
        the block name) — the harness parameterization mechanism
        (reference ``tst/regression_test.py:85-145``)."""
        block, _, key = path.rpartition("/")
        if not block:
            raise DeckError(f"path must contain a block: {path!r}")
        self._assign(block, key, str(value))

    def update(self, modified: dict) -> "Deck":
        for path, value in (modified or {}).items():
            self.set(path, value)
        return self

    # ------------------------------------------------------------------ output
    def dumps(self) -> str:
        out = []
        for block, kv in self.blocks.items():
            out.append(f"<{block}>")
            for k, v in kv.items():
                out.append(f"{k} = {v}")
            out.append("")
        return "\n".join(out)

    def write(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())
