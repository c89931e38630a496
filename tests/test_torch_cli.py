"""The port's file CLI (python -m wah_tpu_torch, --device cpu) against
python -m wah_tpu: the files are byte-equal, and each package reads what
the other wrote."""
import numpy as np
import pytest

from conftest import random_bitmap
from wah_tpu import __main__ as jcli
from wah_tpu_torch import __main__ as cli
from wah_tpu_torch import native

CPU = ["--device", "cpu"]


def _raw(nbytes: int, density: float, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return (rng.random(nbytes // 4 + 1) < density).astype("<u4").tobytes()[:nbytes]


@pytest.mark.parametrize("nbytes", [40001, 4 * 992 * 3, 5, 0])
@pytest.mark.parametrize("codec", ["cpu", "native"])
def test_cli_roundtrip_and_files_equal_jax(tmp_path, codec, nbytes):
    if codec == "native" and not native.available():
        pytest.skip("no native toolchain")
    flags = CPU if codec == "cpu" else ["--native"]
    raw = _raw(nbytes, 0.02, 7)
    src = tmp_path / "bm.bin"
    src.write_bytes(raw)
    wah, jwah = tmp_path / "bm.wah", tmp_path / "bm_jax.wah"
    cli.main(["compress", str(src), "-o", str(wah), *flags])
    jcli.main(["compress", str(src), "-o", str(jwah), "--kernel", "xla"])
    assert wah.read_bytes() == jwah.read_bytes()
    cli.main(["info", str(wah)])
    # each package reads the other's file
    out, jout = tmp_path / "bm.out", tmp_path / "bm_jax.out"
    cli.main(["decompress", str(jwah), "-o", str(out), *flags])
    jcli.main(["decompress", str(wah), "-o", str(jout), "--kernel", "xla"])
    assert out.read_bytes() == raw and jout.read_bytes() == raw


def test_cli_default_output_names(tmp_path):
    src = tmp_path / "b.bin"
    src.write_bytes(_raw(5000, 0.1, 9))
    cli.main(["compress", str(src), *CPU])
    assert (tmp_path / "b.bin.wah").exists()
    src.unlink()
    cli.main(["decompress", str(tmp_path / "b.bin.wah"), *CPU])
    assert src.read_bytes() == _raw(5000, 0.1, 9)


def test_cli_info_matches_jax(tmp_path, capsys):
    src = tmp_path / "b.bin"
    src.write_bytes(_raw(20000, 0.05, 3))
    wah = tmp_path / "b.wah"
    cli.main(["compress", str(src), "-o", str(wah), *CPU])
    capsys.readouterr()
    cli.main(["info", str(wah)])
    got = capsys.readouterr().out
    jcli.main(["info", str(wah)])
    assert got == capsys.readouterr().out


@pytest.mark.parametrize("bad", [b"NOPE" + b"\0" * 28, b"WAHT\x02\0\0\0" + b"\0" * 8, b"WAH"],
                         ids=["magic", "version", "truncated"])
def test_cli_rejects_bad_files(tmp_path, bad):
    path = tmp_path / "x.wah"
    path.write_bytes(bad)
    with pytest.raises(SystemExit):
        cli.main(["info", str(path)])


@pytest.mark.parametrize("op,k", [("or", 3), ("and", 3), ("xor", 4), ("and", 2), ("andnot", 3)])
def test_cli_logical_matches_jax_and_numpy(tmp_path, op, k):
    cols = [random_bitmap(992 + 37, d, seed=80 + i)
            for i, d in zip(range(k), [1 / 16, 0.3, 0.0, 0.9])]
    paths = []
    for i, c in enumerate(cols):
        p = tmp_path / f"c{i}.bin"
        p.write_bytes(c.astype("<u4").tobytes())
        cli.main(["compress", str(p), "-o", str(p) + ".wah", *CPU])
        paths.append(str(p) + ".wah")
    out, jout = str(tmp_path / "r.wah"), str(tmp_path / "r_jax.wah")
    cli.main(["logical", op, *paths, "-o", out, *CPU])
    jcli.main(["logical", op, *paths, "-o", jout, "--kernel", "xla"])
    with open(out, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()
    dec = str(tmp_path / "r.bin")
    cli.main(["decompress", out, "-o", dec, *CPU])
    fold = {"or": lambda a, b: a | b, "and": lambda a, b: a & b, "xor": lambda a, b: a ^ b,
            "andnot": lambda a, b: a & ~b}[op]
    want = cols[0]
    for c in cols[1:]:
        want = fold(want, c)
    np.testing.assert_array_equal(np.fromfile(dec, dtype="<u4"), want)


def test_cli_logical_rejects_unequal_lengths(tmp_path):
    paths = []
    for i, n in enumerate((100, 104)):
        p = tmp_path / f"c{i}.bin"
        p.write_bytes(_raw(n, 0.5, i))
        cli.main(["compress", str(p), *CPU])
        paths.append(str(p) + ".wah")
    with pytest.raises(SystemExit):
        cli.main(["logical", "or", *paths, "-o", str(tmp_path / "o.wah"), *CPU])


def test_cli_default_device_is_the_card():
    """Without --device the CLI runs on the GPU: on a machine without one it
    fails instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["compress", __file__, "-o", "/dev/null"])
