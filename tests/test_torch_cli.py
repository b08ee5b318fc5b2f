"""Port parity: the synthesis CLI and ``mcd_validate`` on a tiny checkpoint.

The same weights (JAX ``init_params`` at ``tiny_config()``, the duration
head pinned to 4 fine frames a token, so both packages round to the same
durations) go into an orbax checkpoint for the JAX CLI and a flat one for
the port's, with one tiny Vocos pickle written by the port
(``weights.vocos_params_to_jax``) that both read.  The port's CLI with
``--phoneme_ids --device cpu`` writes, per speaker, a wav of the length the
JAX CLI writes.  ``mcd_validate`` scores the port's synthesis of a
two-row filelist: finite MCDs.
"""

import math
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from matcha_tpu import cli as jax_cli
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.train import checkpoint as jax_ckpt
from matcha_tpu.utils.audio_io import read_wav, write_wav
from matcha_tpu_torch import cli
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.train.checkpoint import save_tree
from matcha_tpu_torch.utils import mcd_validate
from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params
from matcha_tpu_torch.weights import vocos_params_to_jax

CFG = tiny_config()
VCFG = VocosConfig(input_channels=CFG.n_feats, dim=16, intermediate_dim=32, num_layers=1)
FIXTURES = Path(__file__).resolve().parent.parent / "mcd_validation"
IDS = "5,17,42,8,99,3,61,250,7,12"


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchcli")
    params = jax.tree.map(np.asarray, jax.jit(lambda k: init_params(jax_tiny_config(), k))(jax.random.PRNGKey(0)))
    head = params["encoder"]["proj_w"][f"Conv_{CFG.duration_predictor.n_layers}"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.full_like(head["bias"], math.log(6.0))
    tree = {"params": params, "step": np.asarray(0)}
    jax_ckpt.save_checkpoint(root / "jax_ckpt", tree, jax_tiny_config())
    save_tree(root / "port_ckpt", tree, CFG)
    with open(root / "vocos.pkl", "wb") as f:
        pickle.dump(vocos_params_to_jax(init_vocos_params(VCFG, torch.Generator().manual_seed(1)), VCFG), f)
    return root


def test_cli_writes_the_jax_lengths(model_files, capsys):
    root = model_files
    common = ["--phoneme_ids", IDS, "--vocoder_path", str(root / "vocos.pkl"), "--spk", "0,3"]
    jax_cli.main([*common, "--checkpoint_path", str(root / "jax_ckpt"), "--output_dir", str(root / "jax_out")])
    capsys.readouterr()
    cli.main([*common, "--checkpoint_path", str(root / "port_ckpt"), "--output_dir", str(root / "port_out"),
              "--device", "cpu", "--debug"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[+]")]
    assert len(lines) == 2 and all("RTF=" in line for line in lines)
    for spk in (0, 3):
        name = f"speaker_{spk:03d}"
        got, sr = read_wav(root / "port_out" / f"{name}.wav")
        want, _ = read_wav(root / "jax_out" / f"{name}.wav")
        assert sr == 24000 and len(got) == len(want) > 0
        assert np.isfinite(got).all()
        durations = (root / "port_out" / f"{name}_durations.tsv").read_text().split("\n")
        assert [float(line.split("\t")[1]) for line in durations if line] == [4.0] * 10
        assert (root / "port_out" / f"{name}_encoder.wav").exists()


def test_cli_needs_a_card_unless_cpu_is_asked(model_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--phoneme_ids", IDS, "--checkpoint_path", str(model_files / "port_ckpt"),
                  "--output_dir", str(model_files / "nowhere")])


def test_mcd_validate_scores_the_port_synthesis(model_files, capsys):
    root = model_files
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rows = []
    for i in range(2):
        wav, sr = read_wav(FIXTURES / f"original_speaker_00{i}.wav")
        write_wav(wav_dir / f"r{i}.wav", wav[:12000], sr)
        rows.append(f"r{i}|{i}|en-us|t|" + IDS.replace(",", " "))
    (root / "validate.csv").write_text("\n".join(rows))
    scores = mcd_validate.main(["--checkpoint_path", str(root / "port_ckpt"), "--vocoder_path",
                                str(root / "vocos.pkl"), "--filelist", str(root / "validate.csv"),
                                "--wav_dir", str(wav_dir), "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(scores) == 2 and all(np.isfinite(scores))
    assert "speaker   0: MCD" in out and "average MCD" in out
