"""The reference's own VM-level benchmark workloads, reimplemented.

Reference docs/benchmarks.md:1-12 ran misterbisson/simple-container-
benchmarks against each VM: a "/disk" request writing 1 GiB of zeros to
disk and a "/cpu" request md5-hashing 256 MiB of random numbers, reporting
seconds and MB/s per request. Reimplementing them natively (no container
round-trip) keeps the published baseline numbers directly comparable
(BASELINE.md table: Triton 128.8 MB/s disk, 15.96 MB/s cpu).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from pathlib import Path

DISK_BYTES_DEFAULT = 1 << 30       # 1 GiB of zeros (docs/benchmarks.md:8-9)
CPU_BYTES_DEFAULT = 256 << 20      # 256 MiB hashed (docs/benchmarks.md:11-12)
_CHUNK = 4 << 20


def disk_benchmark(path: Path, total_bytes: int = DISK_BYTES_DEFAULT) -> dict:
    """Write zeros to `path`, fsync, report MB/s (the "/disk" request)."""
    chunk = b"\0" * _CHUNK
    start = time.monotonic()
    with path.open("wb") as f:
        written = 0
        while written < total_bytes:
            n = min(_CHUNK, total_bytes - written)
            f.write(chunk[:n])
            written += n
        f.flush()
        os.fsync(f.fileno())
    seconds = time.monotonic() - start
    path.unlink(missing_ok=True)
    return {
        "workload": "disk",
        "bytes": total_bytes,
        "seconds": seconds,
        "mb_per_sec": total_bytes / 1e6 / seconds,
    }


def cpu_benchmark(total_bytes: int = CPU_BYTES_DEFAULT, seed: int = 0) -> dict:
    """md5 over pseudo-random bytes, report MB/s (the "/cpu" request)."""
    rng = int(seed)
    digest = hashlib.md5()
    start = time.monotonic()
    hashed = 0
    while hashed < total_bytes:
        n = min(_CHUNK, total_bytes - hashed)
        # cheap xorshift-filled buffer: "random numbers" per the reference
        # workload without paying os.urandom's syscall cost in the loop
        rng = (rng * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)
        digest.update((rng.to_bytes(8, "little") * ((n + 7) // 8))[:n])
        hashed += n
    seconds = time.monotonic() - start
    return {
        "workload": "cpu",
        "bytes": total_bytes,
        "seconds": seconds,
        "mb_per_sec": total_bytes / 1e6 / seconds,
        "md5": digest.hexdigest(),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--disk-bytes", type=int, default=DISK_BYTES_DEFAULT)
    parser.add_argument("--cpu-bytes", type=int, default=CPU_BYTES_DEFAULT)
    parser.add_argument("--workdir", type=Path, default=Path("."))
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    results = [
        disk_benchmark(args.workdir / ".containerbench.tmp", args.disk_bytes),
        cpu_benchmark(args.cpu_bytes),
    ]
    if args.json:
        for result in results:
            print(json.dumps(result, sort_keys=True))
    else:
        for result in results:
            print(
                f"/{result['workload']} request: {result['seconds']:.6f}s, "
                f"{result['mb_per_sec']:.2f} MB/s"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
