"""Jensen-Shannon geographic-reference accuracy metric (geo preset), the
port's own copy of ``icek_tpu/metrics/js_geo.py``.

Re-implements the reference's JSGeoMetric
(geo-aware/jensen_shannon_metric.py:8-245): detect "spatial preposition
[+ of/the/a] + entity" patterns in generated captions, bin the referenced
entity's distance / azimuth / OSM type, accumulate a random-entity baseline,
and report the Jensen-Shannon *distance* (sqrt of base-2 JSD) of each
preposition x feature distribution against the train-set distributions.

Artifact contract preserved: constructed from the reference's
``data/bins_distance.pkl`` / ``bins_azimuth.pkl`` / ``OSM_types_index.pkl``
/ ``geo_probability_distr_train.pkl``; results() writes
``geo_probability_distr_generated.pkl`` and ``_random.pkl``.
"""

from __future__ import annotations

import math
import os
import pickle
import random
from typing import Dict, List, Optional, Sequence

DISTANCE_TERMS = {"near", "along", "across", "in"}
TYPE_TERMS = {"along", "across", "in"}
FILLER = {"of", "the", "a"}


def _fresh_store() -> Dict[str, Dict]:
    store = {
        "near": {"n_occurrences": 0, "distance": [], "distance_probs": []},
    }
    for term in ("along", "across", "in"):
        store[term] = {
            "n_occurrences": 0, "distance": [], "distance_probs": [],
            "type": [], "type_probs": [],
        }
    for term in ("north", "south", "east", "west"):
        store[term] = {"n_occurrences": 0, "azimuth": [], "azimuth_probs": []}
    return store


class JSGeoMetric:
    def __init__(
        self,
        word_map: Dict[str, int],
        bins_distance: Sequence,
        bins_azimuth: Sequence,
        osm_type_count: int,
        train_distributions: Optional[Dict] = None,
        print_metrics: bool = True,
        output_dir: Optional[str] = None,
        rng: Optional[random.Random] = None,
    ):
        self.word_map = word_map
        self.rev_word_map = {v: k for k, v in word_map.items()}
        self.bins_distance = list(bins_distance)
        self.bins_azimuth = list(bins_azimuth)
        self.osm_type_count = osm_type_count
        self.train_distributions = train_distributions
        self.print_metrics = print_metrics
        self.output_dir = output_dir
        self.rng = rng or random
        if "north_of" not in word_map:
            self.azimuth_words = ["north", "south", "east", "west"]
        else:
            self.azimuth_words = ["north_of", "south_of", "east_of", "west_of"]
        spatial = ["near", "in", "across", "along"] + self.azimuth_words
        self.geoterm_ids = {word_map[w] for w in spatial if w in word_map}
        self.generated = _fresh_store()
        self.random_baseline = _fresh_store()

    @classmethod
    def from_data_dir(cls, word_map, data_dir: str, **kw) -> "JSGeoMetric":
        def load(name):
            with open(os.path.join(data_dir, name), "rb") as f:
                return pickle.load(f)

        osm = load("OSM_types_index.pkl")
        return cls(
            word_map,
            load("bins_distance.pkl"),
            load("bins_azimuth.pkl"),
            len(osm),
            load("geo_probability_distr_train.pkl"),
            output_dir=data_dir,
            **kw,
        )

    # -- accumulation ---------------------------------------------------

    def _decode_entity_name(self, names, idx) -> str:
        from icek_torch.data.codec import decode_name

        row = names[idx]
        return decode_name([int(c) for c in row[2:]], int(row[1]))

    def _preceding_geo_term(self, seq: List[int], i: int) -> Optional[str]:
        """The spatial preposition governing an entity token at position i,
        allowing 'of'/'the'/'a' fillers (reference :75-101)."""
        V = len(self.word_map)
        prev = [int(seq[i - k]) for k in range(1, min(i, 3) + 1)]
        if prev[0] >= V:
            return None  # previous token is also an entity

        def word(idx):
            return self.rev_word_map.get(idx, "")

        term = None
        if prev[0] in self.geoterm_ids:
            term = word(prev[0])
        elif len(prev) > 1 and prev[1] in self.geoterm_ids and word(prev[0]) in FILLER:
            term = word(prev[1])
        elif (
            len(prev) > 2
            and prev[2] in self.geoterm_ids
            and prev[1] < V
            and word(prev[1]) == "of"
            and word(prev[0]) in {"the", "a"}
        ):
            term = word(prev[2])
        if term and "_" in term:
            term = term.split("_")[0]
        return term

    def _bin_and_store(self, store, idx, term, entity_features):
        dist = float(entity_features[idx][1])
        azim = float(entity_features[idx][2])
        typ = float(entity_features[idx][4])
        if term in DISTANCE_TERMS:
            for bin_idx, (lo, hi) in enumerate(self.bins_distance):
                if lo <= dist < hi:
                    store[term]["distance"].append(bin_idx)
                    break
        if term in self.azimuth_words or term + "_of" in self.azimuth_words:
            for bin_idx, (lo, hi) in enumerate(self.bins_azimuth):
                if lo <= azim < hi:
                    store[term]["azimuth"].append(bin_idx)
                    break
        if term in TYPE_TERMS:
            store[term]["type"].append(typ)

    def run(self, seq, entity_features, entity_names):
        """Accumulate one generated sequence (extended-vocab ids)."""
        V = len(self.word_map)
        seq = [int(t) for t in seq]
        n_rows = len(entity_features)
        for i, token in enumerate(seq):
            if i == 0 or token < V:
                continue
            term = self._preceding_geo_term(seq, i)
            if term is None:
                continue
            idx = token - V
            if idx >= n_rows:
                continue
            name = self._decode_entity_name(entity_names, idx)
            if "unk_ent" in name:
                continue
            self.generated[term]["n_occurrences"] += 1
            self._bin_and_store(self.generated, idx, term, entity_features)
            # random-entity baseline over non-dummy rows
            candidates = [
                x for x in range(n_rows)
                if "unk_ent" not in self._decode_entity_name(entity_names, x)
            ]
            if candidates:
                self.random_baseline[term]["n_occurrences"] += 1
                self._bin_and_store(
                    self.random_baseline, self.rng.choice(candidates), term,
                    entity_features,
                )

    # -- reporting ------------------------------------------------------

    @staticmethod
    def _kl(p, q) -> float:
        total = 0.0
        for pi, qi in zip(p, q):
            if pi > 0 and qi > 0:
                total += pi * math.log2(pi / qi)
        return total

    @classmethod
    def js_distance(cls, p, q) -> float:
        m = [(pi + qi) / 2 for pi, qi in zip(p, q)]
        return math.sqrt(0.5 * cls._kl(p, m) + 0.5 * cls._kl(q, m))

    def _to_probs(self, store):
        for term, data in store.items():
            n = data["n_occurrences"]
            for feature, bins in (
                ("distance", self.bins_distance),
                ("azimuth", self.bins_azimuth),
            ):
                if feature in data and not data[f"{feature}_probs"]:
                    data[f"{feature}_probs"] = [
                        data[feature].count(i) / n if n else 0.0
                        for i in range(len(bins))
                    ]
            if "type" in data and not data["type_probs"]:
                data["type_probs"] = [
                    data["type"].count(i) / n if n else 0.0
                    for i in range(self.osm_type_count)
                ]
        return store

    def compute(self, store) -> Dict[str, Dict[str, float]]:
        """{term: {feature: js_distance}} vs the train distributions."""
        self._to_probs(store)
        out: Dict[str, Dict[str, float]] = {}
        for term, data in store.items():
            out[term] = {"n_occurrences": data["n_occurrences"]}
            if data["n_occurrences"] == 0 or self.train_distributions is None:
                continue
            for feature in data:
                if not feature.endswith("_probs"):
                    continue
                name = feature.split("_")[0]
                # the train table carries BOTH the raw per-occurrence bin
                # list ("distance") and the probability vector
                # ("distance_probs"); the reference compares prob-vs-prob
                # (jensen_shannon_metric.py:215-221), so read the vector.
                ref = self.train_distributions[term][feature]
                out[term][name] = self.js_distance(
                    list(ref), list(data[feature])
                )
        return out

    def results(self):
        gen = self.compute(self.generated)
        rand = self.compute(self.random_baseline)
        if self.print_metrics:
            for label, table in (("GEO-AWARE", gen), ("RANDOM GEO-ENTITY", rand)):
                print(f"\n{label}:\n")
                for term, features in table.items():
                    print(term.upper())
                    print(f"Number of occurrences: {features['n_occurrences']}")
                    for name, val in features.items():
                        if name != "n_occurrences":
                            print(f"{name}: {val}")
                    print()
        if self.output_dir:
            for name, store in (
                ("geo_probability_distr_generated.pkl", self.generated),
                ("geo_probability_distr_random.pkl", self.random_baseline),
            ):
                with open(os.path.join(self.output_dir, name), "wb") as f:
                    pickle.dump(store, f, protocol=pickle.HIGHEST_PROTOCOL)
        return gen, rand
