"""Multi-model registry of compressed binary weights (port of
``repro.runtime.weight_store``).

Each registered tensor is held in the paper's DRAM layout — one varlen
Huffman *stream* — and in the substream-parallel *tiled* layout the decode
kernel consumes.  Unlike the reference, which re-decodes the stream with
the scalar ``decode_stream`` loop on first use (about 33 s per
full-width minitron matrix), the tiles are cut at registration from the
sequences just encoded (``compression.tile_stream`` gives the same words
either way), and the sequences are then dropped.

:meth:`WeightStore.materialize` rebuilds the serving params with every
compressed leaf reconstructed as sign * per-channel scale, on the device:
tiles come through the :class:`DecodeTileCache`, a layer's missing tiles
are decoded by **one** launch of the decode kernel over
``(T_missing, W, S)``, and the assembled weights are memoised until a tile
misses again.  Hit/miss/byte counters stay per tile and equal to the
reference's on the same access sequence, and so do the prefetch counters:
with ``prefetch`` on, the next layer's missing tiles are launched right
after the current layer's are fetched (the launch is asynchronous on the
card, as jax's dispatch was).  The telemetry phases are the reference's
(``weights.materialize``, ``weights.prefetch``, ``weights.decode_tile``),
except that one ``weights.decode_tile`` span covers one launch, with the
number of tiles it decoded in its ``tiles`` argument, where the
reference's covers one tile.

:meth:`WeightStore.fused_operands` gives a layer's operands for the fused
decode + xnor-popcount GEMM (``kernels.ops.compressed_binary_matmul``),
built from the same cache-served tiles, so both paths see the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack, compression, frequency, huffman
from repro_torch.kernels import ops, ref
from repro_torch.kernels.huffman_decode import huffman_decode
from repro_torch.runtime.decode_cache import DecodeTileCache
from repro_torch.runtime.telemetry import NULL_TELEMETRY
from repro_torch.tree import tree_map_with_path


def default_select(path: str, ndim: int) -> bool:
    """Default compression predicate: MLP projection matrices."""
    parts = path.split("/")
    return ndim >= 2 and parts[-1] in ("up", "gate", "down") \
        and "mlp" in parts[:-1]


@dataclasses.dataclass
class StoredLayer:
    """One compressed (N, K) binary tensor + its dequantisation scale."""

    name: str
    ct: compression.CompressedTensor      # stream + tiled layouts
    scale: np.ndarray                     # (N,) per-output-channel alpha
    n: int                                # output channels (rows of bits)
    k: int                                # true contraction length
    dtype: torch.dtype
    words: torch.Tensor                   # (T, W, S) int32 view, on device
    tables: torch.Tensor                  # (160,) int32, on device
    scale_dev: torch.Tensor               # (N,) float32, on device
    tile_freq: np.ndarray                 # per-tile occurrence mass
    freq_seeded: bool = False

    @property
    def tiled(self) -> compression.TiledStream:
        return self.ct.tiled

    def tile_compressed_bytes(self) -> int:
        return self.tiled.w * self.tiled.s * 4      # uint32 words per tile

    def stream_bytes(self) -> int:
        return int(self.ct.stream_words.size * 4)

    def packed_bytes(self) -> int:
        """9-bit channel-packed baseline footprint (paper's reference)."""
        return self.ct.n_seqs * huffman.SEQ_BITS // 8


@dataclasses.dataclass
class _ModelEntry:
    params: dict
    layers: dict[str, list[StoredLayer]]  # tree path -> per-repeat layers
    stacked: dict[str, bool]              # tree path -> 3-d scan-stacked leaf
    memo: dict = dataclasses.field(default_factory=dict)
    fused_memo: dict = dataclasses.field(default_factory=dict)


def _tile_freq(seqs: np.ndarray, ts: compression.TiledStream) -> np.ndarray:
    """Per-tile share of the layer's sequence-occurrence mass (paper
    §III-A skew): the static prior for FrequencyWeighted eviction.  Tail
    padding indexes a zero sentinel bin so pad slots add no mass."""
    hist = np.append(frequency.sequence_histogram(seqs), 0)
    per_tile = ts.c * ts.s
    padded = np.full(ts.n_tiles * per_tile, hist.size - 1, np.int64)
    padded[: seqs.size] = seqs.ravel()
    return hist[padded.reshape(ts.n_tiles, per_tile)].sum(axis=1)


class WeightStore:
    """Registry: model id -> compressed layers, served through one cache."""

    def __init__(self, cache: DecodeTileCache | None = None, *,
                 prefetch: bool = False, telemetry=None):
        self.cache = cache if cache is not None else DecodeTileCache()
        self.prefetch = prefetch
        self.prefetch_dispatched = 0
        self.prefetch_used = 0
        self.telemetry = telemetry if telemetry is not None \
            else NULL_TELEMETRY
        self._models: dict[str, _ModelEntry] = {}

    # -- registration ------------------------------------------------------
    def register_model(self, model_id: str, params, *,
                       cluster: bool = False) -> dict:
        """Compress every weight ``default_select`` picks into the store.

        Selected 2-d leaves (d_in, d_out) are binarised in the BNN layer
        convention: bits of w.T with per-output-channel scale mean|w|.
        3-d leaves are scan-stacked (R, d_in, d_out) and registered per
        repeat.  Decoded tiles and rebuilt weights live on the leaf's
        device.  Returns a summary dict (layer count, byte footprints)."""
        if model_id in self._models:
            raise ValueError(f"model {model_id!r} already registered")
        layers: dict[str, list[StoredLayer]] = {}
        stacked: dict[str, bool] = {}

        def visit(name, leaf):
            if not isinstance(leaf, torch.Tensor) or \
                    not default_select(name, leaf.ndim) or leaf.ndim not in (2, 3):
                return leaf
            # float32 holds float32 and bfloat16 weights exactly
            host = leaf.detach().float().cpu().numpy()
            stack = host[None] if leaf.ndim == 2 else host
            layers[name] = [
                self._compress_tensor(f"{name}[{r}]", stack[r], leaf.dtype,
                                      leaf.device, cluster=cluster)
                for r in range(stack.shape[0])]
            stacked[name] = leaf.ndim == 3
            # the uncompressed original is NOT retained: only its
            # shape/dtype stub stays in the serving tree skeleton
            return torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")

        skeleton = tree_map_with_path(visit, params)
        if not layers:
            raise ValueError("no weights matched the compression predicate")
        self._models[model_id] = _ModelEntry(params=skeleton, layers=layers,
                                             stacked=stacked)
        return self.report(model_id)

    def _compress_tensor(self, name: str, w2: np.ndarray, dtype, device, *,
                         cluster: bool) -> StoredLayer:
        wt = np.ascontiguousarray(w2.T)                # (N=d_out, K=d_in)
        scale = np.abs(wt).mean(axis=1)                # binarize_weights alpha
        bits = (wt >= 0).astype(np.uint8)
        seqs = bitpack.gemm_to_sequences(bits)
        ct = compression.compress_sequences(seqs, bits.shape, "gemm",
                                            cluster=cluster)
        if ct.replacement is not None:                 # the clustered seqs
            seqs = ct.replacement[seqs]                # that were encoded
        return StoredLayer(
            name=name, ct=ct, scale=scale, n=wt.shape[0], k=wt.shape[1],
            dtype=dtype,
            words=torch.from_numpy(np.ascontiguousarray(
                ct.tiled.words).view(np.int32)).to(device),
            tables=torch.from_numpy(ct.decode_tables()).to(device),
            scale_dev=torch.from_numpy(scale.astype(np.float32)).to(device),
            tile_freq=_tile_freq(seqs, ct.tiled))

    # -- tile-level serving ------------------------------------------------
    def _seed_layer(self, model_id: str, layer: StoredLayer) -> None:
        """Push the layer's per-tile occurrence mass into the cache policy
        (once) so FrequencyWeighted eviction can rank its tiles."""
        if layer.freq_seeded:
            return
        for t in range(layer.tiled.n_tiles):
            self.cache.seed_frequency((model_id, layer.name, t),
                                      float(layer.tile_freq[t]))
        layer.freq_seeded = True

    def _decode(self, layer: StoredLayer, tiles: list[int]) -> list:
        """One decode launch over the listed tiles -> one (C, S) int32
        tensor per tile, each with storage of its own: a view into the
        launch's output would keep all of it alive while any one of its
        tiles stayed cached, and evicting a tile would free nothing."""
        idx = torch.tensor(tiles, dtype=torch.long, device=layer.words.device)
        out = huffman_decode(layer.words.index_select(0, idx), layer.tables,
                             c=layer.tiled.c)
        return [tile.clone() for tile in out]

    def _prefetch_layer(self, model_id: str, layer: StoredLayer,
                        pending: dict) -> None:
        """Launch the decode of the layer's missing tiles ahead of use;
        the results land in ``pending``."""
        missing = [t for t in range(layer.tiled.n_tiles)
                   if (model_id, layer.name, t) not in self.cache
                   and (model_id, layer.name, t) not in pending]
        if not missing:
            return                      # steady state: stay off the device
        with self.telemetry.timed("weights.prefetch", layer=layer.name,
                                  tiles=len(missing)):
            for t, tile in zip(missing, self._decode(layer, missing)):
                pending[(model_id, layer.name, t)] = tile
            self.prefetch_dispatched += len(missing)

    def _fetch_tiles(self, model_id: str, layer: StoredLayer,
                     pending: dict | None = None) -> tuple[list, bool]:
        """All decode tiles of one layer via the cache ->
        (tiles [(C, S) int32], any_tile_missed).

        Accesses run in tile order exactly as the reference's: a miss is
        charged (``put``) at its turn, consuming a prefetched decode when
        one exists; the other misses are decoded together by one launch
        afterwards and their entries filled in."""
        ts = layer.tiled
        self._seed_layer(model_id, layer)
        comp_bytes = layer.tile_compressed_bytes()
        tile_nbytes = ts.c * ts.s * 4                  # int32 tiles
        tiles: list = []
        to_decode: list[int] = []
        any_miss = False
        for t in range(ts.n_tiles):
            key = (model_id, layer.name, t)
            tile = self.cache.get(key)
            if tile is None:
                tile = pending.pop(key, None) if pending else None
                if tile is not None:
                    self.prefetch_used += 1
                else:
                    to_decode.append(t)
                self.cache.put(key, tile, nbytes=tile_nbytes,
                               streamed_bytes=comp_bytes)
                any_miss = True
            tiles.append(tile)
        if to_decode:
            with self.telemetry.timed("weights.decode_tile",
                                      tiles=len(to_decode)):
                decoded = self._decode(layer, to_decode)
            for t, tile in zip(to_decode, decoded):
                tiles[t] = tile
                self.cache.fill((model_id, layer.name, t), tile)
        return tiles, any_miss

    def _to_weights(self, layer: StoredLayer, tiles: list) -> torch.Tensor:
        """Cached tiles -> (d_in, d_out) tensor sign * alpha, on device."""
        seqs = ref.tiled_to_sequences(torch.stack(tiles), layer.ct.n_seqs)
        bits = ref.sequences_to_gemm(seqs.reshape(layer.ct.seq_shape),
                                     layer.k)
        w = (bits.float() * 2.0 - 1.0) * layer.scale_dev[:, None]
        return w.T.to(layer.dtype)

    # -- model-level serving ----------------------------------------------
    def materialize(self, model_id: str):
        """Serving params: compressed leaves rebuilt from cached tiles.

        Call once per step; once every tile hits, the memoised device
        tensors are returned as they are (the hit path only touches the
        cache for accounting).  With ``prefetch`` on, layer i+1's missing
        tiles are launched right after layer i's tiles are fetched."""
        entry = self._models[model_id]
        names = list(entry.layers)
        pending: dict = {}
        rebuilt: dict = {}
        with self.telemetry.timed("weights.materialize", model=model_id):
            for i, name in enumerate(names):
                stack = entry.layers[name]
                fetched = [self._fetch_tiles(model_id, l, pending)
                           for l in stack]
                if self.prefetch and i + 1 < len(names):
                    for nxt in entry.layers[names[i + 1]]:
                        self._prefetch_layer(model_id, nxt, pending)
                if all(not miss for _, miss in fetched) \
                        and name in entry.memo:
                    rebuilt[name] = entry.memo[name]
                    continue
                arrs = [self._to_weights(l, tiles)
                        for l, (tiles, _) in zip(stack, fetched)]
                out = torch.stack(arrs) if entry.stacked[name] else arrs[0]
                entry.memo[name] = out
                rebuilt[name] = out
        return tree_map_with_path(lambda path, leaf: rebuilt.get(path, leaf),
                                  entry.params)

    def fused_operands(self, model_id: str, path: str, repeat: int = 0, *,
                       gather: str = "onehot", codes: int | None = None):
        """(words, tables, meta) for the fused decode+GEMM kernel on the
        layer's device, built from the same cache-served tiles as
        :meth:`materialize`; memoised until one of the layer's tiles
        misses the cache again."""
        entry = self._models[model_id]
        layer = entry.layers[path][repeat]
        codes = codes or compression.DEFAULT_CODES_PER_SUB
        mkey = (path, repeat, gather, codes)
        tiles, miss = self._fetch_tiles(model_id, layer)
        if not miss and mkey in entry.fused_memo:
            return entry.fused_memo[mkey]
        seqs = ref.tiled_to_sequences(torch.stack(tiles), layer.ct.n_seqs)
        bits = bitpack.sequences_to_gemm(
            seqs.cpu().numpy().astype(np.uint16).reshape(layer.ct.seq_shape),
            layer.k)
        words, tables, meta = ops.prepare_compressed_gemm(
            bits, cluster=False, gather=gather, codes=codes,
            device=layer.words.device)
        meta["scale"] = layer.scale_dev
        entry.fused_memo[mkey] = (words, tables, meta)
        return entry.fused_memo[mkey]

    # -- introspection -----------------------------------------------------
    def models(self) -> list[str]:
        return list(self._models)

    def layers(self, model_id: str) -> dict[str, list[StoredLayer]]:
        return self._models[model_id].layers

    def n_tiles(self, model_id: str) -> int:
        return sum(l.tiled.n_tiles
                   for ls in self._models[model_id].layers.values()
                   for l in ls)

    def decoded_bytes(self, model_id: str) -> int:
        """Total decoded-tile bytes of the model (cache working set)."""
        return sum(l.tiled.n_tiles * l.tiled.c * l.tiled.s * 4
                   for ls in self._models[model_id].layers.values()
                   for l in ls)

    def prom_metrics(self) -> list:
        """(name, kind, getter, help) rows for a pull-based metrics
        registry (``ServeMetrics.registry`` prefixes them ``store_``)."""
        return [
            ("prefetch_dispatched_total", "counter",
             lambda: self.prefetch_dispatched,
             "tile decodes dispatched ahead of use"),
            ("prefetch_used_total", "counter",
             lambda: self.prefetch_used,
             "prefetched tile decodes consumed by a miss"),
        ]

    def report(self, model_id: str) -> dict:
        entry = self._models[model_id]
        ls = [l for stack in entry.layers.values() for l in stack]
        packed = sum(l.packed_bytes() for l in ls)
        stream = sum(l.stream_bytes() for l in ls)
        return {
            "layers": len(ls),
            "packed_bytes": packed,
            "stream_bytes": stream,
            "ratio_stream": packed / max(stream, 1),
        }
