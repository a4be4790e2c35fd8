"""kopen transparent-open parity (bwalib/kopen.c:268-336)."""

import gzip
import os
import threading

import pytest

from compseed.io.fastq import read_fastq_chunks
from compseed.io.kopen import _needs_shell, kopen_text

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FQ = os.path.join(FIX, "reads.fq")


def _names(path):
    return [r.name for chunk in read_fastq_chunks(path, 1 << 30)
            for r in chunk]


def test_plain_vs_pipe_exec():
    # '/' is punctuation outside kopen's safe set, so this goes via shell
    assert _needs_shell(f"cat {FQ}")
    assert not _needs_shell("cat reads.fq")
    assert _names(f"<cat {FQ}") == _names(FQ)


def test_shell_pipe():
    got = _names(f"< cat {FQ} | head -8")
    assert got == _names(FQ)[:2]


def test_gzip_sniff_on_pipe(tmp_path):
    gz = tmp_path / "reads.fq.gz"
    gz.write_bytes(gzip.compress(open(FQ, "rb").read()))
    assert _names(f"<cat {gz}") == _names(FQ)
    assert _names(str(gz)) == _names(FQ)


def test_http_source():
    import functools
    from http.server import HTTPServer, SimpleHTTPRequestHandler

    handler = functools.partial(SimpleHTTPRequestHandler, directory=FIX)
    srv = HTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/reads.fq"
        assert _names(url) == _names(FQ)
    finally:
        srv.shutdown()


def test_pipe_exit_code_ignored():
    # a command producing nothing yields zero reads, not an exception
    f = kopen_text("<true")
    assert f.read() == ""


@pytest.mark.parametrize("bad", ["/nonexistent/x.fq"])
def test_missing_file_raises(bad):
    with pytest.raises(OSError):
        kopen_text(bad)
