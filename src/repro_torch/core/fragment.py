"""Fragmentation Module (§V, CoBFS [4]) — CoARESF = FM ∘ CoARES.

A file f is a linked list of coverable blocks: genesis block b0 (file
metadata + head pointer) followed by data blocks. The Block Identification
(BI) pipeline (paper Fig. 2):

  1. *Block Division* — content-defined chunking (gear-hash CDC standing in
     for rabin fingerprints; ``repro_torch.kernels.cdc_gearhash``).
  2. *Block Matching* — Ratcliff/Obershelp sequence matching on block hashes
     (``difflib.SequenceMatcher`` — literally the paper's citation [9]) giving
     equality / modified / inserted / deleted statuses.
  3. *Block Updates* — coverable writes on only the affected blocks; inserted
     chains are written **back-to-front** so the list is always connected
     (Lemma 13); deletes write an empty value (blocks are never unlinked).

``fm_reconfig`` (Alg 3) walks the list and issues dsmm-reconfig (Alg 2) on
every block, genesis included (§V text).

Genesis metadata (unified schema, ISSUE 2): BOTH modes store the pickled
ordered block-id index in the genesis block, so indexed readers can batch
block I/O over files written by either mode. ``parse_genesis_meta`` stays
tolerant of the legacy non-indexed schema (a raw 4-byte block count), for
which readers fall back to the linked-list walk.

Batched block I/O (ISSUE 2): with an index present, ``fm_read``/``fm_update``
/``fm_reconfig`` ride the DSM's multi-object batch operations — ONE quorum
fan-out carries every block (O(1) quorum rounds instead of O(#blocks)), and
the EC DAP decodes/encodes the whole file with one fused GF(256) matmul.
``batched=False`` keeps the per-object path (a Join of independent quorum
ops) for ablation benchmarks.
"""
from __future__ import annotations

import hashlib
import pickle
from difflib import SequenceMatcher
from typing import Generator

from repro_torch.core.tags import Config, OpRecord
from repro_torch.kernels.cdc_gearhash.ops import split_chunks
from repro_torch.net.sim import Join, Sleep

SEP = "\x01"


def genesis_id(fid: str) -> str:
    return f"{fid}{SEP}g"


def encode_block_value(ptr: str | None, data: bytes) -> bytes:
    pb = (ptr or "").encode()
    return len(pb).to_bytes(2, "big") + pb + data


def decode_block_value(raw: bytes | None) -> tuple[str | None, bytes]:
    if raw in (None, b""):
        return None, b""
    plen = int.from_bytes(raw[:2], "big")
    ptr = raw[2 : 2 + plen].decode() or None
    return ptr, raw[2 + plen :]


def encode_genesis_meta(index: list[str]) -> bytes:
    """Unified genesis metadata: the full ordered block-id index."""
    return pickle.dumps(list(index), protocol=2)


def parse_genesis_meta(meta: bytes) -> list[str] | None:
    """Return the block index, or None for the legacy schema (the non-indexed
    mode used to store a raw 4-byte block count; pickle protocol-2 streams
    start with 0x80, a count < 2^24 cannot)."""
    if not meta or meta[:1] != b"\x80":
        return None
    try:
        index = pickle.loads(meta)
    except Exception:
        return None
    if isinstance(index, (list, tuple)) and all(isinstance(b, str) for b in index):
        return list(index)
    return None


def _h(data: bytes) -> bytes:
    return hashlib.sha1(data).digest()


class FragmentationModule:
    """Binds a DSM client (CoARES or static) to the fragmented-object logic.

    ``dsm`` must expose generator methods ``cvr_read(obj)``,
    ``cvr_write(obj, value)``, their multi-object batch forms
    ``cvr_read_batch``/``cvr_write_batch``, ``recon``/``recon_batch`` and a
    ``version`` dict (coverability state, updated from reads per CoBFS).
    """

    def __init__(
        self,
        net,
        dsm,
        *,
        min_block: int = 512,
        avg_block: int = 1024,
        max_block: int = 4096,
        history: list | None = None,
        indexed: bool = False,
        batched: bool = True,
    ):
        self.net = net
        self.dsm = dsm
        self.min_block = min_block
        self.avg_block = avg_block
        self.max_block = max_block
        self.history = history if history is not None else []
        self.clseq: dict[str, int] = {}
        # ``indexed`` (beyond-paper, EXPERIMENTS.md §Perf storage iteration):
        # the genesis block stores the full ordered block-id index, so block
        # reads/writes issue in PARALLEL instead of walking the linked
        # list — O(1) quorum rounds instead of O(#blocks). Connectivity
        # reduces to the single coverable genesis flip. The paper itself
        # flags sequential block requests as its main read overhead (§VII-D).
        self.indexed = indexed
        # ``batched``: route indexed block I/O through the DSM's multi-object
        # batch ops (one RPC fan-out, fused EC coding). False = per-object
        # concurrent ops (Join), kept for the before/after ablation.
        self.batched = batched

    def _precode(self, writes: list[tuple[str, bytes]]) -> None:
        """Hand the update's block values to the DSM so EC DAPs batch-encode
        them in one fused GF(256) matmul (ISSUE 1; no-op for ABD). Only the
        SEQUENTIAL write paths need the hint — ``cvr_write_batch`` sees the
        whole batch and encodes it in one shot by itself."""
        precode = getattr(self.dsm, "precode", None)
        if precode is not None and writes:
            precode([raw for _bid, raw in writes])

    # ------------------------------------------------------------------ ids
    def _new_block_id(self, fid: str) -> str:
        seq = self.clseq.get(fid, 0) + 1
        self.clseq[fid] = seq
        return f"{fid}{SEP}{self.dsm.client_id}{SEP}{seq}"

    # ----------------------------------------------------------------- read
    def _read_block_op(self, bid: str):
        tag, raw = yield from self.dsm.cvr_read(bid)
        return bid, tag, raw

    def _read_blocks(self, bids: list[str]) -> Generator:
        """Read many blocks: ONE batched quorum round (default), or a Join of
        independent per-block quorum ops (``batched=False`` ablation)."""
        if self.batched:
            res = yield from self.dsm.cvr_read_batch(bids)
            out = []
            for bid in bids:
                tag, raw = res[bid]
                self.dsm.version[bid] = tag
                out.append((bid, raw))
            return out

        results = yield Join([self._read_block_op(b) for b in bids])
        out = []
        for bid, btag, braw in results:
            self.dsm.version[bid] = btag
            out.append((bid, braw))
        return out

    def _walk_chain(self, ptr: str | None) -> Generator:
        """The linked-list walk from a head pointer (non-indexed mode, or a
        legacy count-only genesis). Returns ``[(bid, ptr, data)]``."""
        blocks: list[tuple[str, str | None, bytes]] = []
        seen: set[str] = set()
        while ptr is not None and ptr not in seen:
            seen.add(ptr)
            tag, raw = yield from self.dsm.cvr_read(ptr)
            self.dsm.version[ptr] = tag
            nxt, data = decode_block_value(raw)
            blocks.append((ptr, nxt, data))
            ptr = nxt
        return blocks

    def _read_chain_ex(self, fid: str) -> Generator:
        """``(blocks, had_index)`` — one genesis read + ALL block reads in one
        batched round (indexed mode with an index present), else the walk.
        ``had_index`` tells update paths whether the genesis must be upgraded
        to the indexed schema even when the block list is unchanged."""
        g = genesis_id(fid)
        tag, raw = yield from self.dsm.cvr_read(g)
        self.dsm.version[g] = tag
        ptr, meta = decode_block_value(raw)
        index = parse_genesis_meta(meta)
        if self.indexed and index is not None:
            results = yield from self._read_blocks(index)
            blocks = []
            for bid, braw in results:
                nxt, data = decode_block_value(braw)
                blocks.append((bid, nxt, data))
            return blocks, True
        blocks = yield from self._walk_chain(ptr)
        return blocks, index is not None

    def _read_chain(self, fid: str) -> Generator:
        """Returns [(bid, ptr, data)]; see ``_read_chain_ex``."""
        blocks, _had_index = yield from self._read_chain_ex(fid)
        return blocks

    def _read_chain_batch(self, fids: list[str]) -> Generator:
        """Cross-FILE aggregation of ``_read_chain`` (ISSUE 3): ONE batched
        engine pass for every file's genesis block, then ONE batched pass for
        ALL data blocks of every indexed file — an F-file read costs the same
        quorum rounds as a one-file read. Files whose genesis carries no
        index (legacy schema) fall back to the per-file linked-list walk.
        Returns ``({fid: [(bid, ptr, data)]}, {fid: had_index})``."""
        gids = {fid: genesis_id(fid) for fid in fids}
        gres = yield from self.dsm.cvr_read_batch([gids[f] for f in fids])
        index_of: dict[str, list[str]] = {}
        heads: dict[str, str | None] = {}
        all_blocks: list[str] = []
        for fid in fids:
            tag, raw = gres[gids[fid]]
            self.dsm.version[gids[fid]] = tag
            ptr, meta = decode_block_value(raw)
            index = parse_genesis_meta(meta)
            if index is not None:
                index_of[fid] = index
                all_blocks.extend(index)
            else:
                heads[fid] = ptr
        chains: dict[str, list[tuple[str, str | None, bytes]]] = {}
        # one deduped block round for every indexed file. NB an indexed file
        # whose index is EMPTY (an empty-content write) must still land in
        # ``chains`` — gating the whole loop on ``all_blocks`` used to drop
        # such files from the result entirely (KeyError downstream) whenever
        # the merged batch carried no data blocks at all (ISSUE 4).
        all_blocks = list(dict.fromkeys(all_blocks))
        res = (yield from self.dsm.cvr_read_batch(all_blocks)) if all_blocks else {}
        for fid, index in index_of.items():
            blocks = []
            for bid in index:
                tag, raw = res[bid]
                self.dsm.version[bid] = tag
                nxt, data = decode_block_value(raw)
                blocks.append((bid, nxt, data))
            chains[fid] = blocks
        for fid, ptr in heads.items():
            chains[fid] = yield from self._walk_chain(ptr)
        return chains, {fid: fid in index_of for fid in fids}

    def fm_read(self, fid: str) -> Generator:
        t0 = self.net.now
        blocks = yield from self._read_chain(fid)
        content = b"".join(d for _, _, d in blocks)
        self.history.append(
            OpRecord(
                kind="fm-read", obj=fid, client=self.dsm.client_id,
                start=t0, end=self.net.now,
                extra={"n_blocks": len(blocks), "size": len(content)},
            )
        )
        return content, blocks

    def fm_read_batch(self, fids) -> Generator:
        """Read many FILES in one batched pass (ISSUE 3): with the indexed
        batched FM every file's blocks ride the same two engine passes
        (genesis round + block round), so the quorum-round count is flat in
        the number of files. Without index/batching this degrades gracefully
        to a ``Join`` of independent per-file reads (the ablation baseline).
        Returns ``{fid: (content, blocks)}``."""
        fids = list(dict.fromkeys(fids))
        if not fids:
            return {}
        if not (self.indexed and self.batched):
            results = yield Join([self.fm_read(f) for f in fids])
            return dict(zip(fids, results))
        t0 = self.net.now
        chains, _had_index = yield from self._read_chain_batch(fids)
        out: dict[str, tuple[bytes, list]] = {}
        for fid in fids:
            blocks = chains[fid]
            content = b"".join(d for _, _, d in blocks)
            self.history.append(
                OpRecord(
                    kind="fm-read", obj=fid, client=self.dsm.client_id,
                    start=t0, end=self.net.now,
                    extra={"n_blocks": len(blocks), "size": len(content),
                           "coalesced": len(fids)},
                )
            )
            out[fid] = (content, blocks)
        return out

    # --------------------------------------------------------------- update
    def _plan_blocks(
        self, fid: str, old_blocks: list, content: bytes
    ) -> tuple[list[tuple[str, bytes]], list[bytes]]:
        """Block Division (kernel CDC) + Matching (Ratcliff [9]) + new-block
        id assignment: the target block list ``[(bid, data)]`` for an update.
        Pure computation — shared by ``fm_update`` and ``fm_update_batch``;
        the caller charges the BI latency (``bi_per_byte``)."""
        live = [(bid, data) for bid, _, data in old_blocks if data != b""]
        chunks = split_chunks(
            content, min_size=self.min_block, avg_size=self.avg_block,
            max_size=self.max_block, device=self.net.device,
        )
        if chunks == [b""]:
            chunks = []
        old_hashes = [_h(d) for _, d in live]
        new_hashes = [_h(c) for c in chunks]
        ops = SequenceMatcher(None, old_hashes, new_hashes, autojunk=False).get_opcodes()
        # --- build the target block list -----------------------------------
        target: list[tuple[str | None, bytes]] = []  # (bid | None=new, data)
        for op, i1, i2, j1, j2 in ops:
            if op == "equal":
                target.extend((live[i][0], live[i][1]) for i in range(i1, i2))
            elif op == "delete":
                target.extend((live[i][0], b"") for i in range(i1, i2))
            elif op == "insert":
                target.extend((None, chunks[j]) for j in range(j1, j2))
            elif op == "replace":
                n_pair = min(i2 - i1, j2 - j1)
                target.extend((live[i1 + t][0], chunks[j1 + t]) for t in range(n_pair))
                target.extend((None, chunks[j]) for j in range(j1 + n_pair, j2))
                target.extend((live[i][0], b"") for i in range(i1 + n_pair, i2))
        # keep tombstoned (already-empty) blocks in the chain where they were:
        # they are invisible to matching but must stay linked. We splice them
        # back right after their old predecessor.
        if any(d == b"" for _, _, d in old_blocks):
            merged: list[tuple[str | None, bytes]] = []
            live_ids = {bid for bid, _ in live}
            tomb_after: dict[str | None, list[str]] = {}
            prev_live: str | None = None
            for bid, _, d in old_blocks:
                if d == b"":
                    tomb_after.setdefault(prev_live, []).append(bid)
                else:
                    prev_live = bid
            merged.extend((b, b"") for b in tomb_after.get(None, []))
            for bid, data in target:
                merged.append((bid, data))
                if bid in live_ids:
                    merged.extend((b, b"") for b in tomb_after.get(bid, []))
            target = merged
        # --- assign ids to new blocks ---------------------------------------
        final: list[tuple[str, bytes]] = []
        for bid, data in target:
            final.append((bid if bid is not None else self._new_block_id(fid), data))
        return final, chunks

    def fm_update(self, fid: str, content: bytes) -> Generator:
        """BI + block updates. Returns stats dict (written/collided/...).

        The indexed+batched path IS ``fm_update_batch`` with one file —
        one code path for the changed-block diff, flag accounting and the
        legacy-genesis upgrade rule, single-file or coalesced."""
        if self.indexed and self.batched:
            res = yield from self.fm_update_batch({fid: content})
            return res[fid]
        t0 = self.net.now
        old_blocks, had_index = yield from self._read_chain_ex(fid)
        yield Sleep(self.net.latency.bi_per_byte * (len(content) + 1))
        final, chunks = self._plan_blocks(fid, old_blocks, content)
        # --- diff against old state; write the changed blocks ---------------
        old_state = {bid: (nxt, data) for bid, nxt, data in old_blocks}
        stats = {"written": 0, "collided": 0, "created": 0, "blocks": len(final),
                 "chunks": len(chunks)}
        g = genesis_id(fid)
        new_index = [bid for bid, _ in final]
        old_index = [bid for bid, _n, _d in old_blocks]
        if self.indexed:
            # per-block Join ablation (``batched=False``): same diff and
            # genesis-upgrade rules as fm_update_batch, concurrent quorum
            # ops instead of one batched fan-out
            old_data = {bid: data for bid, _n, data in old_blocks}
            writes = [
                (bid, encode_block_value(None, data))
                for bid, data in final
                if bid not in old_data or old_data[bid] != data
            ]
            self._precode(writes)

            def write_op(bid, raw):
                res = yield from self.dsm.cvr_write(bid, raw)
                return bid, res

            items = yield Join([write_op(b, r) for b, r in writes])
            for bid, ((tag, _v), flag) in items:
                self.dsm.version[bid] = tag
                if flag == "chg":
                    stats["written"] += 1
                    stats["created"] += int(bid not in old_state)
                else:
                    stats["collided"] += 1
            # A legacy count-only genesis MUST be upgraded to the indexed
            # schema even when the block list is unchanged: the data blocks
            # above were written with ptr=None, so without an index the
            # linked-list walk would be severed (silent truncation).
            if new_index != old_index or not had_index:
                head = final[0][0] if final else None
                (tag, _v), flag = yield from self.dsm.cvr_write(
                    g, encode_block_value(head, encode_genesis_meta(new_index))
                )
                self.dsm.version[g] = tag
                if flag == "chg":
                    stats["written"] += 1
                else:
                    stats["collided"] += 1
        else:
            writes: list[tuple[str, bytes]] = []
            for pos in range(len(final)):
                bid, data = final[pos]
                nxt = final[pos + 1][0] if pos + 1 < len(final) else None
                if bid not in old_state or old_state[bid] != (nxt, data):
                    writes.append((bid, encode_block_value(nxt, data)))
            self._precode(writes)
            # write back-to-front so the list is always connected (Lemma 13)
            for bid, raw in reversed(writes):
                is_new = bid not in old_state
                (tag, _v), flag = yield from self.dsm.cvr_write(bid, raw)
                self.dsm.version[bid] = tag
                if flag == "chg":
                    stats["written"] += 1
                    stats["created"] += int(is_new)
                else:
                    stats["collided"] += 1
            # --- genesis: repoint head / refresh the index if changed --------
            if new_index != old_index:
                new_head = final[0][0] if final else None
                (tag, _v), flag = yield from self.dsm.cvr_write(
                    g, encode_block_value(new_head, encode_genesis_meta(new_index))
                )
                self.dsm.version[g] = tag
                if flag == "chg":
                    stats["written"] += 1
                else:
                    stats["collided"] += 1
        stats["success"] = stats["collided"] == 0
        self.history.append(
            OpRecord(
                kind="fm-update", obj=fid, client=self.dsm.client_id,
                start=t0, end=self.net.now, flag="chg" if stats["success"] else "unchg",
                extra=stats,
            )
        )
        return stats

    def fm_update_batch(self, updates: dict) -> Generator:
        """Update many FILES in one batched pass (ISSUE 3): read every file's
        chain (two batched engine passes via ``_read_chain_batch``), run BI
        per file, then write ALL changed data blocks of ALL files in ONE
        batched coverable write — one fused GF(256) encode for the whole
        fan-out — followed by one batched write of every changed genesis
        block (data before genesis keeps Lemma 13's connectivity argument:
        a head flip is the last thing a reader can observe). Files fall back
        to a ``Join`` of per-file updates when the indexed batched path is
        off. Returns ``{fid: stats}``."""
        fids = list(dict.fromkeys(updates))
        if not fids:
            return {}
        if not (self.indexed and self.batched):
            results = yield Join([self.fm_update(f, updates[f]) for f in fids])
            return dict(zip(fids, results))
        t0 = self.net.now
        chains, had_index = yield from self._read_chain_batch(fids)
        yield Sleep(
            self.net.latency.bi_per_byte
            * (sum(len(updates[f]) for f in fids) + len(fids))
        )
        all_writes: dict[str, bytes] = {}
        writes_of: dict[str, list[str]] = {}
        genesis_writes: dict[str, bytes] = {}
        g_of: dict[str, str] = {}
        stats_of: dict[str, dict] = {}
        old_state_of: dict[str, dict] = {}
        for fid in fids:
            old_blocks = chains[fid]
            final, chunks = self._plan_blocks(fid, old_blocks, updates[fid])
            old_state_of[fid] = {bid: (nxt, data) for bid, nxt, data in old_blocks}
            stats_of[fid] = {"written": 0, "collided": 0, "created": 0,
                             "blocks": len(final), "chunks": len(chunks)}
            old_data = {bid: data for bid, _n, data in old_blocks}
            writes_of[fid] = []
            for bid, data in final:
                if bid not in old_data or old_data[bid] != data:
                    all_writes[bid] = encode_block_value(None, data)
                    writes_of[fid].append(bid)
            new_index = [bid for bid, _ in final]
            # rewrite the genesis when the index changed — or when it held
            # the legacy count-only schema (the blocks above were written
            # with ptr=None; without an index the walk would sever).
            if new_index != [bid for bid, _n, _d in old_blocks] or not had_index[fid]:
                head = final[0][0] if final else None
                g = genesis_id(fid)
                g_of[fid] = g
                genesis_writes[g] = encode_block_value(
                    head, encode_genesis_meta(new_index)
                )
        results = yield from self.dsm.cvr_write_batch(all_writes)
        for fid in fids:
            for bid in writes_of[fid]:
                (tag, _v), flag = results[bid]
                self.dsm.version[bid] = tag
                if flag == "chg":
                    stats_of[fid]["written"] += 1
                    stats_of[fid]["created"] += int(bid not in old_state_of[fid])
                else:
                    stats_of[fid]["collided"] += 1
        gresults = yield from self.dsm.cvr_write_batch(genesis_writes)
        for fid, g in g_of.items():
            (tag, _v), flag = gresults[g]
            self.dsm.version[g] = tag
            if flag == "chg":
                stats_of[fid]["written"] += 1
            else:
                stats_of[fid]["collided"] += 1
        for fid in fids:
            stats = stats_of[fid]
            stats["success"] = stats["collided"] == 0
            self.history.append(
                OpRecord(
                    kind="fm-update", obj=fid, client=self.dsm.client_id,
                    start=t0, end=self.net.now,
                    flag="chg" if stats["success"] else "unchg",
                    extra={**stats, "coalesced": len(fids)},
                )
            )
        return stats_of

    # --------------------------------------------------------------- recon
    def _recon_walk(self, ptr: str | None, new_config: Config) -> Generator:
        """Legacy count-only genesis: reconfigure block by block along the
        chain, reusing the (tag, value) each recon already transferred
        instead of re-reading every block. Returns #blocks moved."""
        n = 0
        seen: set[str] = set()
        while ptr is not None and ptr not in seen:
            seen.add(ptr)
            bres = yield from self.dsm.recon_batch((ptr,), new_config)
            _bcfg, btag, braw = bres[ptr]
            self.dsm.version[ptr] = btag
            ptr, _ = decode_block_value(braw)
            n += 1
        return n

    def fm_reconfig(self, fid: str, new_config: Config) -> Generator:
        """Alg 3: issue dsmm-reconfig (Alg 2) on every block, genesis
        included. With an index present all data blocks ride ONE batched
        recon (batched consensus + one batched state transfer); a legacy
        count-only genesis falls back to the linked-list walk, reusing the
        (tag, value) each recon already transferred instead of re-reading
        every block."""
        t0 = self.net.now
        g = genesis_id(fid)
        res = yield from self.dsm.recon_batch((g,), new_config)
        _cfg, gtag, graw = res[g]
        self.dsm.version[g] = gtag
        ptr, meta = decode_block_value(graw)
        index = parse_genesis_meta(meta)
        if index is not None:
            if self.batched:
                yield from self.dsm.recon_batch(index, new_config)
            else:

                def recon_op(bid):
                    yield from self.dsm.recon(bid, new_config)
                    return bid

                yield Join([recon_op(b) for b in index])
            n = 1 + len(index)
        else:
            n = 1 + (yield from self._recon_walk(ptr, new_config))
        self.history.append(
            OpRecord(
                kind="fm-recon", obj=fid, client=self.dsm.client_id,
                start=t0, end=self.net.now,
                extra={"n_blocks": n, "config": new_config.cfg_id},
            )
        )
        return n

    def fm_reconfig_batch(self, fids, new_config: Config) -> Generator:
        """Reconfigure many FILES to one target configuration in one batched
        pass (ISSUE 3): every file's genesis rides ONE batched recon (batched
        consensus + one batched state transfer), then ALL indexed data blocks
        of ALL files ride a second one — O(1) quorum rounds however many
        files move. Legacy count-only genesis files fall back to the per-file
        walk; ``batched=False`` degrades to a ``Join`` of per-file recons.
        Returns ``{fid: n_blocks_moved}``."""
        fids = list(dict.fromkeys(fids))
        if not fids:
            return {}
        if not self.batched:
            results = yield Join([self.fm_reconfig(f, new_config) for f in fids])
            return dict(zip(fids, results))
        t0 = self.net.now
        gids = {fid: genesis_id(fid) for fid in fids}
        res = yield from self.dsm.recon_batch(
            [gids[f] for f in fids], new_config
        )
        all_blocks: list[str] = []
        nblocks: dict[str, int] = {}
        walk_heads: dict[str, str | None] = {}
        for fid in fids:
            _cfg, gtag, graw = res[gids[fid]]
            self.dsm.version[gids[fid]] = gtag
            ptr, meta = decode_block_value(graw)
            index = parse_genesis_meta(meta)
            if index is not None:
                all_blocks.extend(index)
                nblocks[fid] = 1 + len(index)
            else:
                walk_heads[fid] = ptr
        if all_blocks:
            yield from self.dsm.recon_batch(
                list(dict.fromkeys(all_blocks)), new_config
            )
        for fid, ptr in walk_heads.items():
            nblocks[fid] = 1 + (yield from self._recon_walk(ptr, new_config))
        for fid in fids:
            self.history.append(
                OpRecord(
                    kind="fm-recon", obj=fid, client=self.dsm.client_id,
                    start=t0, end=self.net.now,
                    extra={"n_blocks": nblocks[fid], "config": new_config.cfg_id,
                           "coalesced": len(fids)},
                )
            )
        return nblocks
