"""libfaketime shims: make a DB binary run under a skewed, rate-warped
clock.

Rebuild of jepsen.faketime (jepsen/src/jepsen/faketime.clj): replace an
executable with a bash wrapper that invokes the original (moved to
<cmd>.no-faketime) under ``faketime -m -f "<+/-offset>s x<rate>"``.
Idempotent: re-wrapping only rewrites the wrapper.

The port's copy of ``jepsen_tpu.faketime``.
"""

from __future__ import annotations

from jepsen_tpu_torch import control


def script(cmd: str, init_offset: float, rate: float) -> str:
    """The wrapper script body (faketime.clj:8-18)."""
    off = int(init_offset)
    sign = "-" if off < 0 else "+"
    return (f"#!/bin/bash\n"
            f'faketime -m -f "{sign}{abs(off)}s x{float(rate)}" '
            f'{cmd} "$@"')


def exists(test: dict, node, path: str) -> bool:
    """Remote file-existence probe (control/util.clj:17-22)."""
    try:
        control.exec(test, node, "test", "-e", path)
        return True
    except control.RemoteError:
        return False


def wrap(test: dict, node, cmd: str, init_offset: float, rate: float) -> None:
    """Replace cmd with a faketime wrapper; original moves to
    <cmd>.no-faketime (faketime.clj:20-31). Idempotent."""
    orig = f"{cmd}.no-faketime"
    wrapper = script(orig, init_offset, rate)
    if not exists(test, node, orig):
        control.exec(test, node, "mv", cmd, orig)
    control.execute(test, node,
                    f"echo {control.escape(wrapper)} > "
                    f"{control.escape(cmd)}")
    control.exec(test, node, "chmod", "a+x", cmd)
