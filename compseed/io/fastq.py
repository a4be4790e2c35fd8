"""Read-batch input: FASTQ and compressor-reordered raw lines.

Contracts: bseq_read (bwalib/bwa.c:78-111) — chunking by base count with
name /1 /2 trimming; input_reorder_reads (main.cpp:36-58) — one sequence
per line, names are running integers starting at 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator


@dataclass
class Read:
    name: str
    seq: str
    qual: str | None
    comment: str | None
    sam: str | None = None


def _opener(path: str):
    """Transparent open: plain/gzip file, '-' stdin, '<cmd' pipe, http://
    and ftp:// URLs (kopen semantics, bwalib/kopen.c:268-336)."""
    from compseed.io.kopen import kopen_text

    return kopen_text(path)


def _as_stream(src):
    """Accept either a path or an already-open text stream (single-open
    contract: '<cmd' pipes / URLs must not be re-opened per consumer)."""
    return _opener(src) if isinstance(src, str) else src


class _PushbackText:
    """Text stream replaying ``head`` before ``base`` — the gzungetc
    equivalent used by the format sniff (main.cpp:399-406)."""

    def __init__(self, head: str, base):
        self._head = head
        self._base = base

    def readline(self) -> str:
        if self._head:
            line, self._head = self._head + self._base.readline(), ""
            return line
        return self._base.readline()

    def read(self, n: int = -1) -> str:
        if self._head:
            if n is None or n < 0:
                data, self._head = self._head + self._base.read(), ""
                return data
            take, self._head = self._head[:n], self._head[n:]
            if len(take) < n:
                take += self._base.read(n - len(take))
            return take
        return self._base.read(n)

    def __iter__(self):
        while True:
            line = self.readline()
            if not line:
                return
            yield line

    def close(self) -> None:
        self._base.close()


def sniff_open(path: str):
    """Open once, sniff the first character, and return
    ``(is_fastq, stream)`` with the character pushed back — so pipe/URL
    inputs are consumed exactly once (kopen only opens one stream)."""
    f = _opener(path)
    first = f.read(1)
    return first == "@", _PushbackText(first, f)


def _trim_readno(name: str) -> str:
    if len(name) > 2 and name[-2] == "/" and name[-1].isdigit():
        return name[:-2]
    return name


def read_fastq_chunks(path, chunk_size: int) -> Iterator[list[Read]]:
    """Yield chunks of reads totalling >= chunk_size bases (even count)."""
    f = _as_stream(path)
    batch: list[Read] = []
    size = 0
    while True:
        hdr = f.readline()
        if not hdr:
            break
        hdr = hdr.rstrip("\n")
        if hdr.startswith("@"):
            parts = hdr[1:].split(None, 1)
            name = _trim_readno(parts[0])
            comment = parts[1] if len(parts) > 1 else None
            seq = f.readline().strip()
            plus = f.readline()
            qual = f.readline().strip() if plus.startswith("+") else None
        elif hdr.startswith(">"):
            parts = hdr[1:].split(None, 1)
            name = _trim_readno(parts[0])
            comment = parts[1] if len(parts) > 1 else None
            seq = f.readline().strip()
            qual = None
        else:
            continue
        batch.append(Read(name=name, seq=seq, qual=qual, comment=comment))
        size += len(seq)
        if size >= chunk_size and len(batch) % 2 == 0:
            yield batch
            batch, size = [], 0
    if batch:
        yield batch
    f.close()


def read_reordered_chunks(path, chunk_size: int) -> Iterator[list[Read]]:
    """Raw reordered reads: one sequence per line, integer names from 1."""
    f = _as_stream(path)
    batch: list[Read] = []
    size = 0
    counter = 1
    for line in f:
        seq = line.rstrip("\n")
        if not seq:
            continue
        batch.append(Read(name=str(counter), seq=seq, qual=None, comment=None))
        counter += 1
        size += len(seq)
        if size >= chunk_size and len(batch) % 2 == 0:
            yield batch
            batch, size = [], 0
    if batch:
        yield batch
    f.close()


def sniff_is_fastq(path: str) -> bool:
    """main.cpp:399-406: first character '@' selects FASTQ parsing."""
    if path == "-":
        return True
    f = _opener(path)
    first = f.read(1)
    f.close()
    return first == "@"


def read_fastq_pair_chunks(path1: str, path2: str,
                           chunk_size: int) -> Iterator[list[Read]]:
    """Interleave two FASTQ files pairwise (bseq_read with two kseq
    streams, bwalib/bwa.c:90-99); chunk boundaries stay on pair edges."""
    g1 = read_fastq_chunks(path1, 1)   # chunk of one pair at a time
    g2 = read_fastq_chunks(path2, 1)
    batch: list[Read] = []
    size = 0
    while True:
        r1 = next(g1, None)
        r2 = next(g2, None)
        if r1 is None or r2 is None:
            break
        for a, b in zip(r1, r2):
            batch.extend((a, b))
            size += len(a.seq) + len(b.seq)
        if size >= chunk_size:
            yield batch
            batch, size = [], 0
    if batch:
        yield batch
