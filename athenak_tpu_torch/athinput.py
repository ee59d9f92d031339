"""INI-style "athinput" parameter files.

A copy of ``athenak_tpu/athinput.py``, kept in the port so that the port
never imports the JAX package.  API parity with the reference
``ParameterInput`` class (reference: src/parameter_input.hpp:67-97):
``<block>`` section headers,
``name = value  # comment`` lines, typed Get/GetOrAdd/Set accessors,
command-line ``block/name=value`` overrides, parameter dumps, and
unused-parameter warnings.

Pure host-side Python: the reference parses on rank 0 and broadcasts; here
there is a single host process, so a plain parser suffices.
"""

from __future__ import annotations

import io
import re
import sys
from collections import OrderedDict
from typing import List, Optional, Tuple


class ParameterInput:
    """Parsed athinput parameter database.

    Blocks are ordered dicts of name -> (value_string, comment, accessed).
    """

    def __init__(self) -> None:
        self.blocks: "OrderedDict[str, OrderedDict[str, List]]" = OrderedDict()

    # ------------------------------------------------------------------ load
    @classmethod
    def from_file(cls, fname: str) -> "ParameterInput":
        pin = cls()
        with open(fname, "r") as f:
            pin._parse(f.read())
        return pin

    @classmethod
    def from_string(cls, text: str) -> "ParameterInput":
        pin = cls()
        pin._parse(text)
        return pin

    def _parse(self, text: str) -> None:
        block = None
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"^<\s*([^>]+?)\s*>", line)
            if m:
                block = m.group(1)
                if block not in self.blocks:
                    self.blocks[block] = OrderedDict()
                continue
            if block is None:
                continue
            if "=" not in line:
                continue
            name, _, rest = line.partition("=")
            name = name.strip()
            # strip trailing comment (not inside the value if quoted — values
            # are never quoted in athinput decks)
            val, _, comment = rest.partition("#")
            val = val.strip()
            comment = comment.strip()
            # multiple <output N> style blocks: duplicates within a block
            # silently overwrite, same as reference behavior
            self.blocks[block][name] = [val, comment, False]

    # --------------------------------------------------------------- helpers
    def _entry(self, block: str, name: str) -> List:
        try:
            e = self.blocks[block][name]
        except KeyError:
            raise KeyError(
                f"parameter '{name}' not found in block <{block}>") from None
        e[2] = True
        return e

    def does_block_exist(self, block: str) -> bool:
        return block in self.blocks

    def does_parameter_exist(self, block: str, name: str) -> bool:
        return block in self.blocks and name in self.blocks[block]

    # ------------------------------------------------------------------- get
    def get_string(self, block: str, name: str) -> str:
        return str(self._entry(block, name)[0])

    def get_real(self, block: str, name: str) -> float:
        return float(self._entry(block, name)[0])

    def get_integer(self, block: str, name: str) -> int:
        return int(float(self._entry(block, name)[0]))

    def get_boolean(self, block: str, name: str) -> bool:
        v = str(self._entry(block, name)[0]).lower()
        if v in ("true", "1", "yes", "t"):
            return True
        if v in ("false", "0", "no", "f"):
            return False
        raise ValueError(f"<{block}>/{name} = '{v}' is not a boolean")

    # ----------------------------------------------------------- get-or-add
    def _get_or_add(self, block: str, name: str, default) -> str:
        if not self.does_parameter_exist(block, name):
            self.set_value(block, name, default)
        return self._entry(block, name)[0]

    def get_or_add_string(self, block: str, name: str, default: str) -> str:
        return str(self._get_or_add(block, name, default))

    def get_or_add_real(self, block: str, name: str, default: float) -> float:
        return float(self._get_or_add(block, name, default))

    def get_or_add_integer(self, block: str, name: str, default: int) -> int:
        return int(float(self._get_or_add(block, name, default)))

    def get_or_add_boolean(self, block: str, name: str, default: bool) -> bool:
        if not self.does_parameter_exist(block, name):
            self.set_value(block, name, "true" if default else "false")
        return self.get_boolean(block, name)

    # ------------------------------------------------------------------- set
    def set_value(self, block: str, name: str, value) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        if block not in self.blocks:
            self.blocks[block] = OrderedDict()
        if name in self.blocks[block]:
            self.blocks[block][name][0] = str(value)
        else:
            self.blocks[block][name] = [str(value), "", False]

    set_string = set_value
    set_real = set_value
    set_integer = set_value
    set_boolean = set_value

    # -------------------------------------------------------------- override
    def modify_from_cmdline(self, args: List[str]) -> None:
        """Apply ``block/name=value`` overrides.

        Mirrors ``ParameterInput::ModifyFromCmdline``
        (reference: src/parameter_input.hpp:81).
        """
        for arg in args:
            m = re.match(r"^([^/=]+)/([^=]+)=(.*)$", arg)
            if not m:
                raise ValueError(
                    f"cannot parse command-line override '{arg}'; expected "
                    "block/name=value")
            self.set_value(m.group(1), m.group(2).strip(), m.group(3).strip())

    # ------------------------------------------------------------------ dump
    def dump(self, stream: Optional[io.TextIOBase] = None) -> str:
        """Write the parameter database in athinput format."""
        out = io.StringIO()
        for bname, entries in self.blocks.items():
            out.write(f"<{bname}>\n")
            for name, (val, comment, _) in entries.items():
                if comment:
                    out.write(f"{name} = {val}    # {comment}\n")
                else:
                    out.write(f"{name} = {val}\n")
            out.write("\n")
        text = out.getvalue()
        if stream is not None:
            stream.write(text)
        return text

    def check_unused_parameters(self, stream=sys.stdout
                                ) -> List[Tuple[str, str]]:
        """Warn about parameters never read (parity:
        ``ParameterInput::CheckUnusedParameters``)."""
        unused = []
        for bname, entries in self.blocks.items():
            if bname == "comment":
                continue
            for name, (_, _, accessed) in entries.items():
                if not accessed:
                    unused.append((bname, name))
        if unused and stream is not None:
            for bname, name in unused:
                print(f"# Warning: parameter <{bname}>/{name} was never used",
                      file=stream)
        return unused
