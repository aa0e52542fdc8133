"""The benchmark's daemon wrapper with a fault planted under the timed
path (``PORTBENCH_FAULT``): for the serving cell's fault tests only."""

import os
import sys

from portbench.drivers import serve_daemon
from portbench.tests.faults import plant

if __name__ == "__main__":
    plant(setattr, os.environ["PORTBENCH_FAULT"])
    sys.exit(serve_daemon.main())
