"""``python -m repro_torch.analysis`` — run the protocol-invariant lint pack."""
import sys

from repro_torch.analysis.invariants import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
