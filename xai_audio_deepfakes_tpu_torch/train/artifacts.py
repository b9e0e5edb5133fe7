"""Visual debugging artifacts: mask, spectrogram, waveform-mask and
feature PNGs (port of `train/artifacts.py`).

The reference's matplotlib dumps: viridis, origin lower, a time-frequency
extent, masks on a fixed [0, 1] scale, spectrograms as log1p. matplotlib is
imported when a function is called, never at import, so the package
imports without it; where it is missing (the card's machine has none) every
function here raises its ImportError. The arrays may be numpy arrays or
torch tensors on any device (`artifact_fn`'s mask is on the device).
"""

from __future__ import annotations

import os

import numpy as np


def _host(a) -> np.ndarray:
    """A numpy array of `a`, a torch tensor (any device, any float dtype)
    or anything `np.asarray` takes."""
    if hasattr(a, "detach"):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _extent(num_frames: int, sr: int, hop_length: int):
    return [0, num_frames * hop_length / sr, 0, sr / 2]


def save_mask_png(
    mask: np.ndarray, path: str, title: str = "Mask",
    sr: int = 16000, hop_length: int = 322,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mask = _host(mask)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(
        mask, aspect="auto", origin="lower",
        extent=_extent(mask.shape[1], sr, hop_length),
        vmin=0, vmax=1, cmap="viridis",
    )
    ax.set_title(title, fontsize=10)
    ax.set_ylabel("freq Hz")
    ax.set_xlabel("time s")
    fig.colorbar(im, ax=ax, label="Mask Value")
    fig.savefig(path, format="png", bbox_inches="tight", dpi=100)
    plt.close(fig)
    return path


def save_spectrogram_png(
    spec: np.ndarray, path: str, title: str = "Spectrogram",
    sr: int = 16000, hop_length: int = 322, log1p: bool = True,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spec = _host(spec)
    if log1p:
        spec = np.log1p(np.maximum(spec, 0))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig, ax = plt.subplots()
    im = ax.imshow(
        spec, aspect="auto", origin="lower",
        extent=_extent(spec.shape[1], sr, hop_length), cmap="viridis",
    )
    ax.set_title(title)
    ax.set_ylabel("freq (Hz)")
    ax.set_xlabel("time (s)")
    fig.colorbar(im, ax=ax, label="dB")
    fig.savefig(path, format="png", bbox_inches="tight", dpi=100)
    plt.close(fig)
    return path


def save_waveform_mask_png(
    mask: np.ndarray, path: str, wav: np.ndarray | None = None,
    title: str = "Attribution mask", sr: int = 16000,
) -> str:
    """Waveform-domain attribution mask as a line plot
    (`captum_saliency.py:57-65` save_mask), optionally over the waveform."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mask = _host(mask).reshape(-1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    t = np.arange(mask.shape[0]) / sr
    fig, ax = plt.subplots(figsize=(8, 2))
    if wav is not None:
        wav = _host(wav).reshape(-1)
        peak = np.max(np.abs(wav)) + 1e-9
        ax.plot(t, wav / peak, color="#bbbbbb", linewidth=0.4, label="waveform")
    ax.plot(t, mask, color="#1f77b4", linewidth=0.6, label="mask")
    ax.set_xlabel("time s")
    ax.set_ylim(-1.05, 1.05)
    ax.set_title(title, fontsize=9)
    ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(path, format="png", dpi=150)
    plt.close(fig)
    return path


def save_features_png(
    features: np.ndarray, path: str, title: str = "SSL features"
) -> str:
    """Feature-map dump (`train_addvisor.py:59-94` plot_features): [T, H] (or
    [B, T, H] — first item) rendered feature-dim x time, reversed viridis,
    min/max in the title."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    features = _host(features)
    if features.ndim == 3:
        features = features[0]
    data = features.T  # [H, T]
    f_min, f_max = float(data.min()), float(data.max())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig, ax = plt.subplots(figsize=(12, 6))
    im = ax.imshow(
        data, aspect="auto", origin="lower", cmap="viridis_r",
        vmin=f_min, vmax=f_max,
    )
    ax.set_title(f"{title} (Min: {f_min:.2f}, Max: {f_max:.2f})")
    ax.set_ylabel("Feature Dimension")
    ax.set_xlabel("Time Frame")
    fig.colorbar(im, ax=ax, label="Feature Value")
    fig.savefig(path, format="png", bbox_inches="tight", dpi=100)
    plt.close(fig)
    return path
