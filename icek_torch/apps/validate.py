"""Lint a prepared input_dataset_files directory against the file protocol
(port of ``tools/validate_dataset.py``; ``python -m icek_torch.apps
validate``).

Checks a prepared dataset before a long run:

  * file presence per the `{SPLIT}_{KIND}_{base}.{ext}` protocol
    (geo-aware/create_input_files.py:90-130) incl. WORDMAP;
  * wordmap layout: <pad>=0, contiguous word ids, <unk>/<start>/<end>
    as the last three ids (geo-aware/create_input_files.py:311-317);
  * row-count agreement across captions/caplens/capmasks/contexts/HDF5;
  * extended-vocab caption ids within [0, V+E+F) and consistent with the
    per-token mask kind (0 word / 1 entity / 2 fact);
  * caplens within array width, captions framed <start> ... <end>,
    pad beyond the length;
  * context arrays: E+1 / F+1 rows, 52-wide name rows with valid char
    codes and lengths, finite features, fact subject indices in range;
  * image store (h5py): float16, (N, 3, S, S), values in [0, 1].

Usage:
    python -m icek_torch.apps validate DATA_DIR --preset k_georic
    python -m icek_torch.apps validate DATA_DIR --base-name my_set --facts
Exit code 0 = clean, 1 = errors found.
"""

import argparse
import json
import os
import pickle

import numpy as np

from icek_torch.data import codec

SPLITS = ("TRAIN", "VAL", "TEST")


class Lint:
    def __init__(self):
        self.errors = []
        self.warnings = []

    def error(self, msg):
        self.errors.append(msg)
        print(f"ERROR   {msg}")

    def warn(self, msg):
        self.warnings.append(msg)
        print(f"warning {msg}")


def check_wordmap(lint, data_dir, base):
    path = os.path.join(data_dir, f"WORDMAP_{base}.json")
    if not os.path.exists(path):
        lint.error(f"missing {os.path.basename(path)}")
        return None
    with open(path) as f:
        mapping = json.load(f)
    ids = sorted(mapping.values())
    if ids != list(range(len(ids))):
        lint.error("wordmap ids are not contiguous 0..V-1")
    if mapping.get(codec.Wordmap.PAD) != 0:
        lint.error("wordmap <pad> is not id 0")
    n = len(mapping)
    for off, tok in ((3, codec.Wordmap.UNK), (2, codec.Wordmap.START),
                     (1, codec.Wordmap.END)):
        if mapping.get(tok) != n - off:
            lint.error(f"wordmap {tok} is not id V-{off} "
                       f"(got {mapping.get(tok)}, V={n})")
    try:
        return codec.Wordmap(mapping)
    except Exception as e:  # malformed beyond the explicit checks
        lint.error(f"wordmap rejected by codec.Wordmap: {e}")
        return None


def check_name_rows(lint, arr, what, n_expected_cols=52):
    if arr.ndim != 2 or arr.shape[1] != n_expected_cols:
        lint.error(f"{what}: shape {arr.shape}, want (*, {n_expected_cols})")
        return
    lengths = arr[:, 1]
    if (lengths < 0).any() or (lengths > codec.NAME_WIDTH).any():
        lint.error(f"{what}: name lengths outside [0, {codec.NAME_WIDTH}]")
    chars = arr[:, 2:]
    if (chars < 0).any() or (chars > 0x10FFFF).any():
        lint.error(f"{what}: invalid char codes")


def check_split(lint, data_dir, base, split, wm, has_facts, img_size):
    def jpath(kind):
        return os.path.join(data_dir, f"{split}_{kind}_{base}.json")

    def ppath(kind):
        return os.path.join(data_dir, f"{split}_{kind}_{base}.pkl")

    kinds = [("CAPTIONS", jpath), ("CAPLENS", jpath), ("CAPMASKS", jpath),
             ("ENT_FEATURES", ppath), ("ENT_NAMES", ppath)]
    if has_facts:
        kinds += [("FACTS", ppath), ("FACT_NAMES", ppath)]
    missing = [k for k, p in kinds if not os.path.exists(p(k))]
    h5_path = os.path.join(data_dir, f"{split}_IMAGES_{base}.hdf5")
    if not os.path.exists(h5_path):
        missing.append("IMAGES")
    if missing:
        lint.error(f"{split}: missing {missing}")
        return

    with open(jpath("CAPTIONS")) as f:
        captions = np.asarray(json.load(f), dtype=np.int64)
    with open(jpath("CAPLENS")) as f:
        caplens = np.asarray(json.load(f), dtype=np.int64)
    with open(jpath("CAPMASKS")) as f:
        masks = np.asarray(json.load(f), dtype=np.int64)
    with open(ppath("ENT_FEATURES"), "rb") as f:
        ent_features = np.asarray(pickle.load(f), dtype=np.float64)
    with open(ppath("ENT_NAMES"), "rb") as f:
        ent_names = np.asarray(pickle.load(f))
    fact_features = fact_names = None
    if has_facts:
        with open(ppath("FACTS"), "rb") as f:
            fact_features = np.asarray(pickle.load(f), dtype=np.float64)
        with open(ppath("FACT_NAMES"), "rb") as f:
            fact_names = np.asarray(pickle.load(f))

    n = len(captions)
    skewed = False
    for what, arr in [("CAPLENS", caplens), ("CAPMASKS", masks),
                      ("ENT_FEATURES", ent_features), ("ENT_NAMES", ent_names)] \
            + ([("FACTS", fact_features), ("FACT_NAMES", fact_names)]
               if has_facts else []):
        if len(arr) != n:
            lint.error(f"{split}: {what} has {len(arr)} rows, CAPTIONS has {n}")
            skewed = True
    if skewed:
        return
    if n == 0:
        lint.warn(f"{split}: empty split")
        return

    E = ent_names.shape[1] if ent_names.ndim == 3 else 0
    F = fact_names.shape[1] if has_facts and fact_names.ndim == 3 else 0
    V = len(wm) if wm is not None else 0

    if ent_features.ndim != 3:
        lint.error(f"{split}: ENT_FEATURES ndim {ent_features.ndim}, want 3")
    if not np.isfinite(ent_features).all():
        lint.error(f"{split}: non-finite entity features")
    check_name_rows(lint, ent_names.reshape(-1, ent_names.shape[-1]),
                    f"{split}: ENT_NAMES")
    if has_facts:
        if fact_features.ndim != 3 or fact_features.shape[-1] < 3:
            lint.error(f"{split}: FACT_FEATURES shape "
                       f"{fact_features.shape}, want (rows, F+1, 3)")
            return
        if not np.isfinite(fact_features).all():
            lint.error(f"{split}: non-finite fact features")
        check_name_rows(lint, fact_names.reshape(-1, fact_names.shape[-1]),
                        f"{split}: FACT_NAMES")
        subj = fact_features[..., 1].astype(np.int64)
        if (subj < 0).any() or (subj >= E).any():
            lint.error(f"{split}: fact subject indices outside [0, {E})")

    # captions: framing, ranges, mask/id-range agreement
    width = captions.shape[1]
    if (caplens < 2).any() or (caplens > width).any():
        lint.error(f"{split}: caplens outside [2, {width}]")
        return
    if wm is not None:
        rows = np.arange(width)[None, :]
        if (captions[:, 0] != wm.start_id).any():
            lint.error(f"{split}: captions not starting with <start>")
        end_mask = captions == wm.end_id
        if (end_mask.sum(axis=1) != 1).any():
            lint.error(f"{split}: rows without exactly one <end>")
            return
        end_pos = np.argmax(end_mask, axis=1)
        valid = rows <= end_pos[:, None]
        if (captions[~valid] != wm.pad_id).any():
            lint.error(f"{split}: non-<pad> ids after <end>")
        if (valid & (captions == wm.pad_id)).any():
            lint.error(f"{split}: <pad> ids before <end>")
        # two reference caplen conventions: geo stores the true framed
        # length (geo cif.py:268), knowledge/news store the padded width
        # (knowledge cif.py:347) — accept either, per row.
        ok_len = (caplens == end_pos + 1) | (caplens == width)
        if not ok_len.all():
            lint.error(f"{split}: caplens match neither the true-length nor "
                       "the padded-width convention")
        hi = V + E + F
        if (captions < 0).any() or (captions >= hi).any():
            lint.error(f"{split}: caption ids outside [0, {hi}) "
                       f"(V={V} E={E} F={F})")
        else:
            kind = np.zeros_like(captions)
            kind[(captions >= V) & (captions < V + E)] = 1
            kind[captions >= V + E] = 2
            bad = valid & (kind != masks)
            if bad.any():
                i, j = np.argwhere(bad)[0]
                lint.error(
                    f"{split}: caption mask disagrees with id range at "
                    f"row {i} pos {j}: id {captions[i, j]} mask {masks[i, j]}"
                )
        allowed = {0, 1} | ({2} if has_facts else set())
        if not set(np.unique(masks[valid])) <= allowed:
            lint.error(f"{split}: mask kinds outside {sorted(allowed)}")

    import h5py

    with h5py.File(h5_path, "r") as h:
        if "images" not in h:
            lint.error(f"{split}: HDF5 missing 'images' dataset")
            return
        d = h["images"]
        if d.shape != (n, 3, img_size, img_size):
            lint.error(f"{split}: images shape {d.shape}, want "
                       f"({n}, 3, {img_size}, {img_size})")
        if d.dtype != np.float16:
            lint.error(f"{split}: images dtype {d.dtype}, want float16")
        # strided sample across the WHOLE store (h5py wants sorted unique
        # indices) — a corrupt row far into the file must not pass just
        # because it isn't in the first few rows
        n_probe = min(n, 64)
        idx = np.unique(np.linspace(0, n - 1, n_probe).astype(np.int64))
        probe = np.asarray(d[idx], dtype=np.float32)
        if not np.isfinite(probe).all() or probe.min() < 0 or probe.max() > 1:
            lint.error(f"{split}: image values outside [0, 1] "
                       f"(in a {len(idx)}-row strided sample)")
        coverage = f"{len(idx)}/{n} rows value-probed"

    print(f"ok      {split}: {n} rows, E={E}, F={F} ({coverage})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m icek_torch.apps validate",
                                 description="Lint a prepared input files directory")
    ap.add_argument("data_dir", help="input_dataset_files directory")
    ap.add_argument("--preset", choices=["georic", "k_georic", "nytimes800k"])
    ap.add_argument("--base-name", help="override the protocol base name")
    ap.add_argument("--facts", action="store_true",
                    help="expect FACTS/FACT_NAMES (implied by preset)")
    ap.add_argument("--img-size", type=int, default=256)
    args = ap.parse_args(argv)

    has_facts = args.facts
    base = args.base_name
    if args.preset:
        from icek_torch.core import config as config_lib

        cfg = getattr(config_lib, args.preset)()
        base = base or cfg.data.base_name
        has_facts = has_facts or cfg.data.fact_context_size > 0
    if base is None:
        ap.error("need --preset or --base-name")

    lint = Lint()
    wm = check_wordmap(lint, args.data_dir, base)
    for split in SPLITS:
        check_split(lint, args.data_dir, base, split, wm, has_facts,
                    args.img_size)
    print(f"\n{len(lint.errors)} error(s), {len(lint.warnings)} warning(s)")
    return 1 if lint.errors else 0
