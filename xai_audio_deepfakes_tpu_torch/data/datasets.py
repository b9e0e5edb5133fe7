"""Dataset scanners and batching (port of `data/datasets.py`):

  * `extract_wavs`: the first comma-separated column of each metadata line;
  * `find_all_wav_files_per_system`: the MLAAD per-system sampler;
  * `find_wavs_per_language_and_speaker`: the m-ailabs per-language,
    per-speaker sampler;
  * `AudioBatcher`: fixed-shape [B, num_samples] f32 batches, shuffled from a
    seed, decoded on host threads, host-sharded, the ragged tail dropped.

The samplers draw from `random.Random(seed)` and the batcher from
`np.random.default_rng(seed)` in the JAX package's order, so the same seed
gives the same files and the same batches.
"""

from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import Iterator, Sequence

import numpy as np

from xai_audio_deepfakes_tpu_torch.data.io import load_audio
from xai_audio_deepfakes_tpu_torch.data.prefetch import parallel_map


def extract_wavs(metadata_path: str) -> list[str]:
    """First comma-separated column of each non-empty line."""
    out = []
    with open(metadata_path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(line.split(",")[0])
    return out


def _subdirs(path: str) -> list[str]:
    return [d for d in sorted(os.listdir(path)) if os.path.isdir(os.path.join(path, d))]


def find_all_wav_files_per_system(root_dir: str, samples_per_system: int = 3,
                                  seed: int | None = None) -> list[tuple[str, str, str]]:
    """MLAAD layout root/fake/<lang>/<system>/**.wav -> [(path, system, lang)],
    up to `samples_per_system` drawn per system."""
    rng = random.Random(seed)
    fake_root = os.path.join(root_dir, "fake")
    system_to_paths: dict[str, list] = defaultdict(list)
    if not os.path.isdir(fake_root):
        return []
    for lang in _subdirs(fake_root):
        lang_dir = os.path.join(fake_root, lang)
        for system in _subdirs(lang_dir):
            for dirpath, _, filenames in os.walk(os.path.join(lang_dir, system)):
                for fn in filenames:
                    if fn.endswith(".wav"):
                        system_to_paths[system].append((os.path.join(dirpath, fn), lang))
    results = []
    for system, paths in system_to_paths.items():
        chosen = rng.sample(paths, min(samples_per_system, len(paths)))
        results.extend([(p, system, lang) for p, lang in chosen])
    return results


def find_wavs_per_language_and_speaker(
    root_dir: str,
    samples_per_language: int = 6,
    samples_per_speaker: int = 3,
    seed: int | None = None,
) -> list[tuple[str, str, str]]:
    """m-ailabs layout root/<lang>/<lang>/by_book/<gender>/<speaker>/<book>/
    wavs/*.wav -> [(path, speaker, lang)], up to `samples_per_speaker` per
    speaker and `samples_per_language` per language."""
    rng = random.Random(seed)
    results = []
    if not os.path.isdir(root_dir):
        return []
    for lang1 in _subdirs(root_dir):
        lang1_dir = os.path.join(root_dir, lang1)
        speaker_pool = []
        for lang2 in sorted(os.listdir(lang1_dir)):
            by_book = os.path.join(lang1_dir, lang2, "by_book")
            if not os.path.isdir(by_book):
                continue
            for gender in _subdirs(by_book):
                gender_dir = os.path.join(by_book, gender)
                for speaker in _subdirs(gender_dir):
                    speaker_dir = os.path.join(gender_dir, speaker)
                    for book in sorted(os.listdir(speaker_dir)):
                        wavs_dir = os.path.join(speaker_dir, book, "wavs")
                        if not os.path.isdir(wavs_dir):
                            continue
                        wavs = [os.path.join(wavs_dir, f) for f in sorted(os.listdir(wavs_dir))
                                if f.endswith(".wav")]
                        if wavs:
                            chosen = rng.sample(wavs, min(samples_per_speaker, len(wavs)))
                            speaker_pool.append((speaker, chosen))
        selected: list = []
        rng.shuffle(speaker_pool)
        for speaker, wavs in speaker_pool:
            room = samples_per_language - len(selected)
            if room <= 0:
                break
            selected.extend([(f, speaker, lang1) for f in wavs[:room]])
        results.extend(selected)
    return results


class AudioBatcher:
    """File list -> shuffled fixed-shape [B, num_samples] float32 batches,
    numpy on the host (`to_device` or `prefetch_to_device` stage them).

    Host i of `num_shards` reads files i, i + N, i + 2N, ...; the order is
    drawn per epoch from one `np.random.default_rng(seed)`; decoding runs on
    `num_workers` threads, order preserved; with `drop_remainder` the ragged
    tail is dropped, so every batch has one shape.
    """

    def __init__(
        self,
        file_paths: Sequence[str],
        batch_size: int,
        root: str = "",
        sample_rate: int = 16000,
        clip_seconds: float = 5.0,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        num_workers: int = 8,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.file_paths = list(file_paths)[shard_index::num_shards]
        self.batch_size = batch_size
        self.root = root
        self.sample_rate = sample_rate
        self.clip_seconds = clip_seconds
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.num_workers = num_workers
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.file_paths) // self.batch_size
        if not self.drop_remainder and len(self.file_paths) % self.batch_size:
            n += 1
        return n

    def _decode(self, j: int) -> np.ndarray:
        return load_audio(os.path.join(self.root, self.file_paths[j]),
                          target_sr=self.sample_rate, clip_seconds=self.clip_seconds)[0]

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.arange(len(self.file_paths))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order) - (bs - 1 if self.drop_remainder else 0), bs):
            wavs = parallel_map(self._decode, list(order[i : i + bs]),
                                num_workers=self.num_workers)
            yield np.stack(wavs).astype(np.float32)
