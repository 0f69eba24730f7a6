"""python -m kcmc_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import sys

from kcmc_bench.run import main

sys.exit(main())
