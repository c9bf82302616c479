#!/usr/bin/env python3
"""Wall of making page-locked host memory of a streamed B's size, three ways.

    python3 tools/host_pin_times.py

On the card machine, for 6.9 GB (the 32-water cluster's f64 B) and 37.2 GB
(the 64-water cluster's): ``torch.empty`` then ``cudaHostRegister`` (what
``models/df_screened.py::host_empty`` does), the same after ``zero_()``
has faulted the pages in, ``zero_()`` alone, and, for 6.9 GB only,
``torch.empty(pin_memory=True)`` (``cudaHostAlloc`` through PyTorch's
pinned allocator, which rounds the request up to a power of two). Prints
the card's name and power limit first. Needs CUDA; exits 2 without it.
"""

import subprocess
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("host_pin_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.cuda.init()
    cudart = torch.cuda.cudart()
    print(f"torch threads {torch.get_num_threads()}", flush=True)
    for gb in (6.9, 37.2):
        n = int(gb * 1e9 / 8)
        for how in ("empty+register", "empty+zero_+register", "empty+zero_",
                    "pin_memory"):
            if how == "pin_memory" and gb > 10:
                continue   # rounded up to 64 GiB
            t0 = time.perf_counter()
            t = torch.empty(n, dtype=torch.float64,
                            pin_memory=how == "pin_memory")
            t1 = time.perf_counter()
            if "zero_" in how:
                t.zero_()
            t2 = time.perf_counter()
            if "register" in how:
                rc = int(cudart.cudaHostRegister(t.data_ptr(), 8 * n, 0))
                if rc != 0:
                    raise RuntimeError(f"cudaHostRegister: CUDA error {rc}")
            t3 = time.perf_counter()
            print(f"{gb} GB {how}: empty {t1 - t0:.3f} s, zero {t2 - t1:.3f} "
                  f"s, register {t3 - t2:.3f} s, total {t3 - t0:.3f} s, "
                  f"pinned {t.is_pinned()}", flush=True)
            if "register" in how:
                cudart.cudaHostUnregister(t.data_ptr())
            del t
    return 0


if __name__ == "__main__":
    sys.exit(main())
