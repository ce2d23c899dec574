import time

T0 = time.perf_counter()  # set-up is timed from here: imports count

import sys  # noqa: E402

from port_bench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], t0=T0))
