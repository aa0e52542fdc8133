"""``python3 -m portbench``: see :mod:`portbench.run`."""

import sys

from portbench.run import main

sys.exit(main())
