"""The probe of kernels A, C and G
(uavdet_tpu_torch/scripts/kernel_probe.py):
its variants are pieces of text replaced in copies of the CUDA sources, so
every piece must still be in the sources, and its command line must work
where there is no GPU."""

import contextlib
import io

import pytest

from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.scripts import kernel_probe

VARIANTS = [(f"A-{k}", v) for k, v in kernel_probe.A_VARIANTS.items()] \
    + [(f"C-{k}", v) for k, v in kernel_probe.C_VARIANTS.items()] \
    + [(f"G-{k}", v) for k, v in kernel_probe.G_VARIANTS.items()]


@pytest.mark.parametrize("subs", [v for _, v in VARIANTS],
                         ids=[k for k, _ in VARIANTS])
def test_variant_substitutions_apply(tmp_path, subs):
    """Each variant replaces text that the shipped sources hold, and leaves
    a changed copy (or, for the base, an equal one)."""
    kernel_probe.substitute(kernels.CSRC, subs, tmp_path / "v")
    changed = {name for name, _, _ in subs}
    for src in kernels.CSRC.rglob("*"):
        if src.is_dir():
            continue
        rel = src.relative_to(kernels.CSRC)
        same = (tmp_path / "v" / rel).read_text() == src.read_text()
        assert same == (src.name not in changed), rel


def test_substitute_raises_on_text_that_is_gone(tmp_path):
    with pytest.raises(ValueError, match="not found"):
        kernel_probe.substitute(
            kernels.CSRC, [(kernel_probe.NMS, "no such text", "")],
            tmp_path / "v")


def test_variants_cover_what_the_notes_name():
    """The variants the sources' notes and the docstring speak of."""
    for name in ("base", "storeonly", "nosilu", "nosums", "stcs", "tanh"):
        assert name in kernel_probe.A_VARIANTS
        assert f"  {name}" in kernel_probe.__doc__
    for name in ("base", "sets2", "sets4", "noremote", "noexchange",
                 "nostore"):
        assert name in kernel_probe.G_VARIANTS
        assert f"  {name}" in kernel_probe.__doc__ or name.startswith("sets")
    assert "cluster8_threads512" in kernel_probe.C_VARIANTS
    assert len(kernel_probe.C_VARIANTS) == 9


def test_help_needs_no_gpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        kernel_probe.main(["--help"])
    assert e.value.code == 0
    for flag in ("--only", "--parent-csrc", "--iters"):
        assert flag in out.getvalue()
