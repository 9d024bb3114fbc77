"""The port's config loader against the JAX package's (PyYAML): every
file of configs/ and configs/data/ composes to the same dict, override
strings parse to the same values, and YAML outside the subset the port
reads raises ValueError naming the file and line instead of being
misread."""
import glob
import os

import pytest

from behindthescenes_tpu import config as jconfig
from behindthescenes_tpu_torch import config as tconfig

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FILES = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))
               + glob.glob(os.path.join(ROOT, "configs", "data", "*.yaml")))


def test_every_config_file_is_covered():
    assert len(FILES) == 28


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, ROOT) for p in FILES])
def test_config_composes_as_jax(path):
    """load_config (defaults, `_self_`, {group: name} entries, deep merge)
    and the raw file both equal the JAX loader's, lists as lists."""
    want = jconfig.load_config(path)
    got = tconfig.load_config(path)
    assert got == want
    import yaml
    with open(path) as f:
        assert tconfig.load_yaml(path) == yaml.safe_load(f)


OVERRIDES = [
    "checkpoint=media/weights/flagship_fast_conv.npz",
    "renderer.n_fine=16",
    "renderer.fine_reuse_coarse=true",
    "model_conf.nvs_sweep=false",
    "learning_rate=2e-5",          # dotless: a float only by the fix
    "learning_rate=1.0e-4",
    "lr=-3E+2",
    "x=0o17",                      # a string to YAML 1.1; int(value, 0)
    "data.image_size=[24, 32]",
    "data.image_size=[]",
    "renderer.sched=[[0, 100], [64, 32], [0, 16]]",
    "name=\"quoted: string\"",
    "name='it''s'",
    "eval_resolution=null",
    "checkpoint=",
    "checkpoint=~",
    "flag=on",
    "flag=No",
    "a.b.c=plain words",
    "value=1.5 # a comment",
    "n=+7",
    "m=-0",
    "x=.5",
    "x=-.5",
    "x=.inf",
    "key=a=b",
    "nested=k: v",
]


@pytest.mark.parametrize("arg", OVERRIDES)
def test_override_parses_as_jax(arg):
    assert tconfig.parse_cli_overrides([arg]) == \
        jconfig.parse_cli_overrides([arg])


def test_overrides_merge_as_jax():
    args = ["renderer.n_coarse=8", "renderer.n_fine=8", "bf16=false"]
    path = os.path.join(ROOT, "configs", "eval_synthetic_thin_nvs.yaml")
    assert tconfig.load_config(path, tconfig.parse_cli_overrides(args)) == \
        jconfig.load_config(path, jconfig.parse_cli_overrides(args))


OUTSIDE = [
    "a: &anchor 1",
    "a: *alias",
    "a: !!str 1",
    "a: |\n  block",
    "a: >\n  folded",
    "a: {b: 1}",
    "a: [1,\n    2]",
    "a: \"open",
    "a: 010",
    "a: 1_000",
    "a: 1:30",
    "a: 2001-12-14",
    "a:\n  plain\n  continued",
    "a: b: c",
    "a: [x, , y]",
    "---\na: 1",
    "? complex\n: key",
    "a:\n\t- tab",
]


@pytest.mark.parametrize("text", OUTSIDE)
def test_outside_the_subset_raises(tmp_path, text):
    path = tmp_path / "bad.yaml"
    path.write_text("name: x\n" + text + "\n")
    with pytest.raises(ValueError, match=r"bad\.yaml:\d+"):
        tconfig.load_yaml(str(path))


def test_override_outside_the_subset_raises():
    """PyYAML reads 0x1f as 31; the port refuses it rather than guess."""
    with pytest.raises(ValueError, match="0x1f"):
        tconfig.parse_cli_overrides(["x=0x1f"])


def test_find_config_from_another_directory(tmp_path, monkeypatch):
    """-cn finds the repository's configs from any working directory."""
    monkeypatch.chdir(tmp_path)
    path = tconfig.find_config("eval_synthetic_nvs")
    assert os.path.samefile(path, os.path.join(ROOT, "configs",
                                               "eval_synthetic_nvs.yaml"))
    with pytest.raises(FileNotFoundError):
        tconfig.find_config("no_such_config")
