"""Print a config with its ``_base_`` files merged (counterpart of
``tools/misc/print_config.py``).

    python -m orientedobjectdetection_torch.tools.print_config <config>
"""

from __future__ import annotations

import argparse
import sys

from ..utils import Config


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    args = p.parse_args(argv)
    print(Config.fromfile(args.config).dump())
    return 0


if __name__ == '__main__':
    sys.exit(main())
