"""``python -m jepsen_tpu_torch COMMAND [OPTIONS ...]``: the port's
command line, the 13 commands of :func:`jepsen_tpu_torch.cli.default_commands`
(``run``, ``analyze``, ``recover``, ``explain``, ``watch``, ``top``,
``trace``, ``lint``, ``plan``, ``usage``, ``flightrec``, ``serve``,
``stream``); :mod:`jepsen_tpu_torch.cli` says what each does. Exit codes,
as the reference's command line has them: 0 valid, 1 not valid (or
unknown), 254 bad arguments, an unknown command or a missing store, 255 an
internal error, a CUDA device that does not initialise among them.
"""

from __future__ import annotations

import logging
import sys

from jepsen_tpu_torch import cli


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    return cli.run(cli.default_commands(),
                   sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
