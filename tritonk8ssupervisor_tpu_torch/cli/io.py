"""Terminal prompt primitives.

The reference built its whole wizard on one helper, `getArgument`
(reference setup.sh:94-110): ``read -p "prompt [default]: "`` with
empty-input-means-default semantics, plus hand-rolled numbered menus for
networks/packages (setup.sh:309-450) and a literal-"yes" confirmation gate
(setup.sh:471-482). This module gives the same three primitives as a class
with injectable streams so the wizard is unit-testable with scripted input
— the test seam the reference never had (SURVEY.md §4).

The port's copy of `tritonk8ssupervisor_tpu/cli/io.py`, whole and under the
reference's names.
"""

from __future__ import annotations

import sys
from typing import Callable, Sequence, TextIO


class EndOfInput(RuntimeError):
    """Input stream exhausted mid-wizard (non-interactive misuse)."""


class Prompter:
    def __init__(self, in_stream: TextIO | None = None, out: TextIO | None = None):
        self._in = in_stream if in_stream is not None else sys.stdin
        self._out = out if out is not None else sys.stdout

    # -- low level ---------------------------------------------------------

    def say(self, text: str = "") -> None:
        print(text, file=self._out, flush=True)

    def _readline(self) -> str:
        line = self._in.readline()
        if line == "":
            raise EndOfInput("ran out of input while prompting")
        return line.rstrip("\n")

    # -- getArgument analogue (setup.sh:94-110) ----------------------------

    def ask(self, label: str, default: str = "") -> str:
        suffix = f" [{default}]" if default else ""
        print(f"{label}{suffix}: ", end="", file=self._out, flush=True)
        answer = self._readline().strip()
        return answer if answer else default

    def ask_validated(
        self,
        label: str,
        default: str,
        validate: Callable[[str], str],
    ) -> str:
        """Re-prompt until `validate` accepts (returns an error string to
        reject, "" to accept) — the reference's per-field while loops
        (e.g. hostname regex retry, setup.sh:276-283)."""
        while True:
            answer = self.ask(label, default)
            error = validate(answer)
            if not error:
                return answer
            self.say(f"  ! {error}")

    # -- numbered menu (setup.sh:309-450 analogue) -------------------------

    def menu(self, title: str, options: Sequence[str], default_index: int = 0) -> int:
        """Print a numbered menu, return the chosen 0-based index.

        Out-of-range or non-numeric input re-prompts, like the reference's
        menu bounds checks (setup.sh:337-356, 428-448).
        """
        self.say(title)
        for i, option in enumerate(options):
            marker = "*" if i == default_index else ""
            self.say(f"  {i + 1}) {option} {marker}".rstrip())
        while True:
            raw = self.ask("Select", str(default_index + 1))
            try:
                choice = int(raw)
            except ValueError:
                self.say(f"  ! enter a number 1-{len(options)}")
                continue
            if 1 <= choice <= len(options):
                return choice - 1
            self.say(f"  ! enter a number 1-{len(options)}")

    # -- confirmation gate (setup.sh:471-482 analogue) ---------------------

    def confirm(self, question: str) -> bool:
        """True only on literal yes/y — the reference required literal "yes"
        and treated anything else as abort (setup.sh:471-482)."""
        answer = self.ask(f"{question} (yes/no)", "no").lower()
        return answer in ("yes", "y")
