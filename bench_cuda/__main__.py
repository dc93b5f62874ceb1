import sys

from bench_cuda.harness import main

if __name__ == "__main__":
    sys.exit(main())
