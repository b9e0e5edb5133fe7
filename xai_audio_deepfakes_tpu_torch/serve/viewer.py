"""Listening-study gallery (a copy of the JAX package's `serve/viewer.py`):
the serving surface replacing `streamlit_controlled_study.py`.

The reference runs a Streamlit app (plus a pyngrok tunnel) that re-computes
the whole pipeline inside the web process. Here serving is split the
production way: the pipeline emits artifacts once (wavs + PNGs + a
predictions JSON), and `build_gallery` renders a static HTML page over them —
original vs reconstructed audio players, the five spectrogram/mask images,
and the three prediction numbers per item, paginated fakes-first exactly like
the reference UI (`streamlit...py:234-314`). `serve_gallery` hosts the
directory with the stdlib http server (no streamlit, no tunnel).
"""

from __future__ import annotations

import html
import json
import os

import numpy as np


def _item_html(item: dict, polarity_note: str = "") -> str:
    polarity_note = html.escape(polarity_note)
    imgs = "".join(
        f'<figure><img src="{html.escape(item[k])}" loading="lazy">'
        f"<figcaption>{cap}</figcaption></figure>"
        for k, cap in (
            ("spectrogram_img", "Spectrogram"),
            ("mask_img", "Mask"),
            ("masked_spectrogram_img", "Spectrogram x Mask"),
            ("mask_compl_img", "1 - Mask"),
            ("compl_masked_spectrogram_img", "Spectrogram x (1 - Mask)"),
        )
        if k in item
    )
    audio = "".join(
        f'<div><b>{cap}</b><br>'
        f'<audio controls src="{html.escape(item[k])}"></audio></div>'
        for k, cap in (
            ("original_audio", "Original audio"),
            ("reconstructed_audio", "Reconstructed audio"),
            ("irrelevant_audio", "Removed (1 - mask) audio"),
        )
        if k in item
    )
    # render only the prediction fields the artifact actually carries — an
    # index emitted by an older/partial run may have pred_original without
    # the reconstructed pair, and the gallery must not 500 on it
    pred_parts = ", ".join(
        f"{cap}: {item[k]:.4f}"
        for k, cap in (
            ("pred_original", "original"),
            ("pred_reconstructed_mask", "reconstructed"),
            ("pred_reconstructed_1mask", "1-mask"),
        )
        if k in item
    )
    preds = (
        f"<p><b>Predictions</b> (P(class 1); {polarity_note}) — "
        f"{pred_parts}</p>"
        if pred_parts
        else ""
    )
    return f"""
<section class="item">
  <h3>{html.escape(item["source"])}</h3>
  <div class="audio-row">{audio}</div>
  <div class="img-row">{imgs}</div>
  {preds}
</section>
"""


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ADDvisor listening study</title>
<style>
body {{ font-family: sans-serif; margin: 2rem; }}
.item {{ border-bottom: 1px solid #ccc; padding: 1rem 0; }}
.audio-row {{ display: flex; gap: 2rem; }}
.img-row {{ display: flex; gap: .5rem; flex-wrap: wrap; }}
.img-row img {{ max-width: 240px; }}
nav a {{ margin-right: 1rem; }}
</style></head>
<body>
<h1>quality visualisation</h1>
<p>detector polarity: {polarity}</p>
<nav>{nav}</nav>
{items}
</body></html>
"""


def build_gallery(
    results: list[dict],
    out_dir: str,
    items_per_page: int = 8,
    polarity: str = "manipulated_is_one",
) -> str:
    """results: list of dicts with artifact-relative paths and predictions
    (see `pipeline_to_artifacts` in cli). Writes index.html + page_*.html,
    fakes first then reals (reference pagination, `streamlit...py:246-258`).
    The fake/real split honors `polarity` (config.LabelPolarity): the
    reference UI hardcodes p<0.5 == fake, which contradicts how its detector
    was trained (see `config.manipulated_probability`). Returns the index
    path."""
    from xai_audio_deepfakes_tpu_torch.config import manipulated_probability

    os.makedirs(out_dir, exist_ok=True)
    fakes = [
        r for r in results
        if manipulated_probability(r["pred_original"], polarity) >= 0.5
    ]
    reals = [
        r for r in results
        if manipulated_probability(r["pred_original"], polarity) < 0.5
    ]
    polarity_note = (
        "1 = manipulated" if polarity == "manipulated_is_one" else "1 = real"
    )
    pages: list[tuple[str, list]] = []
    for label, group in (("fake", fakes), ("real", reals)):
        for i in range(0, max(len(group), 1), items_per_page):
            chunk = group[i : i + items_per_page]
            if chunk:
                pages.append((f"{label} page {len(pages) + 1}", chunk))
    if not pages:
        pages = [("empty", [])]
    nav = "".join(
        f'<a href="page_{i}.html">{html.escape(name)}</a>' for i, (name, _) in enumerate(pages)
    )
    index_path = os.path.join(out_dir, "index.html")
    for i, (name, chunk) in enumerate(pages):
        body = _PAGE.format(
            nav=nav,
            items="".join(_item_html(it, polarity_note) for it in chunk),
            polarity=polarity,
        )
        with open(os.path.join(out_dir, f"page_{i}.html"), "w") as f:
            f.write(body)
    with open(index_path, "w") as f:
        f.write(
            _PAGE.format(
                nav=nav,
                items="".join(_item_html(it, polarity_note) for it in pages[0][1]),
                polarity=polarity,
            )
        )
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return index_path


# first line of every auto-built fallback index: lets serve_gallery tell a
# pipeline-built gallery (authoritative, never overwritten) from its own
# disposable output (rebuilt every serve so new artifacts appear)
_FALLBACK_MARK = "<!-- fallback-gallery -->\n"


def build_fallback_gallery(directory: str) -> str:
    """Render an index over a directory of loose artifacts that has no
    gallery (e.g. closed-loop outputs written before the gallery feature, or
    hand-assembled dirs): every `<stem>_manipulated.wav` becomes an item with
    its `_relevant`/`_irrelevant` siblings and any index-matched mask/
    spectrogram PNGs (`final_mask_{i}.png`, `manipulated_spec_{i}.png` — the
    closed-loop naming); remaining wavs get bare audio players. No
    predictions are shown — this path never invents numbers the artifacts
    don't record. Returns the index path."""
    files = set(os.listdir(directory))
    wavs = sorted(f for f in files if f.endswith(".wav"))
    stems = [
        f[: -len("_manipulated.wav")]
        for f in wavs
        if f.endswith("_manipulated.wav")
    ]
    # trailing-index -> PNG mapping is only unambiguous when no two stem
    # families share an index (e.g. run_a_0 and run_b_0 would both claim
    # final_mask_0.png — better to show no image than the wrong run's mask)
    indices = [s.rsplit("_", 1)[-1] for s in stems]
    idx_unique = {i for i in indices if indices.count(i) == 1}
    items, used = [], set()
    for stem, idx in zip(stems, indices):
        f = stem + "_manipulated.wav"
        item = {"source": stem, "original_audio": f}
        used.add(f)
        for suffix, key in (
            ("_relevant.wav", "reconstructed_audio"),
            ("_irrelevant.wav", "irrelevant_audio"),
        ):
            if stem + suffix in files:
                item[key] = stem + suffix
                used.add(stem + suffix)
        if idx in idx_unique:
            for name, key in (
                (f"manipulated_spec_{idx}.png", "spectrogram_img"),
                (f"final_mask_{idx}.png", "mask_img"),
            ):
                if name in files:
                    item[key] = name
        items.append(item)
    items.extend(
        {"source": f, "original_audio": f} for f in wavs if f not in used
    )
    index_path = os.path.join(directory, "index.html")
    with open(index_path, "w") as f:
        f.write(
            _FALLBACK_MARK
            + _PAGE.format(
                nav="",
                items="".join(_item_html(it) for it in items),
                polarity="(not recorded in these artifacts)",
            )
        )
    return index_path


def serve_gallery(directory: str, port: int = 8000) -> None:
    import functools
    import http.server

    index = os.path.join(directory, "index.html")
    if not os.path.exists(index):
        print(f"no index.html in {directory} — building fallback gallery")
        build_fallback_gallery(directory)
    else:
        with open(index) as f:
            first = f.readline()
        if first == _FALLBACK_MARK:
            # our own disposable index: rebuild so artifacts added since
            # the last serve appear (a pipeline-built gallery is
            # authoritative and is never touched)
            build_fallback_gallery(directory)
    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=directory
    )
    with http.server.ThreadingHTTPServer(("0.0.0.0", port), handler) as srv:
        print(f"serving {directory} on http://0.0.0.0:{port}")
        srv.serve_forever()
