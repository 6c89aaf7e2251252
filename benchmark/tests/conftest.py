"""CPU tests of the benchmark (run from the repository root:
``python -m pytest benchmark/tests -q``). They import the harness as the
package ``benchmark``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
