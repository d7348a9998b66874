"""Continuous-batching inference server (port of
`ContinuousBatcher`, `SpottingDecodeServer` and `SpottingService` from
`advancedliteratemachinery_tpu/engine/serving.py`).

Requests arrive one item at a time; `ContinuousBatcher` coalesces them into
a fixed batch shape, pads partial batches and fans results back out.
`SpottingDecodeServer` keeps a pool of decode slots on the device and runs
one ragged decode step for every slot per tick, each slot at its own
position over its own encoder memory, so that requests join and leave the
batch between ticks. `SpottingService` wires OmniParser's three stages
through it: a batched encoder, a `pt` server, then every detected instance
fanned out to the `poly` and `rec` servers.

Device work runs from several threads (the encode batcher and the three
servers' workers), all on the device's default stream, so it runs in the
order it was issued: the page memory the encoder writes is read by the
servers after it. Each worker enters `torch.inference_mode` itself (the
mode is per thread). The JAX version's jitted dispatches are eager calls
here, and its donated slot state is updated in place.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.models.layers import (
    cast_matmul_weights)
from advancedliteratemachinery_tpu_torch.models.omniparser import NEG

# how long a decode server's worker waits on its queue while slots are
# live, and how long a page waits for co-travelers into the service's
# encoder batch
POLL_S = 1e-3
BATCH_WAIT_MS = 3.0
# the most requests one refill wave prefills together
MAX_WAVE = 16
# decode steps per dispatch. Each dispatch costs one device→host round trip
# to read its tokens; a burst spreads that over T tokens. The price:
# finished lanes idle until the burst ends and free slots refill only
# between bursts, so T stays well under the typical sequence length.
BURST_TICKS = 8


class ContinuousBatcher:
    def __init__(self, infer_fn: Callable[[np.ndarray], Sequence],
                 batch_size: int, item_shape,
                 max_wait_ms: float = 5.0, dtype=np.uint8):
        """infer_fn: [batch_size, *item_shape] array of `dtype` → sequence
        of per-item results. Requests smaller than batch_size wait up to
        max_wait_ms for co-travelers, then go padded with zeros."""
        self.infer_fn = infer_fn
        self.batch_size = batch_size
        self.item_shape = tuple(item_shape)
        self.max_wait = max_wait_ms / 1000.0
        self.dtype = dtype
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._started = False
        self.stats = {"batches": 0, "items": 0, "padded_slots": 0}

    def start(self) -> "ContinuousBatcher":
        if not self._started:
            self._worker.start()
            self._started = True
        return self

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the worker
        if self._started:
            self._worker.join(timeout=5)

    def submit(self, item: np.ndarray) -> Future:
        """item: [*item_shape] → Future of the per-item result."""
        if item.shape != self.item_shape:
            raise ValueError(f"item shape {item.shape} != {self.item_shape}")
        fut: Future = Future()
        self._q.put((np.asarray(item, self.dtype), fut))
        return fut

    def _collect(self) -> List:
        """Block for the first item, then soak up to batch_size within
        max_wait."""
        first = self._q.get()
        if first is None or self._stop.is_set():
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.batch_size:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _batch(self, items: List[np.ndarray]) -> np.ndarray:
        """The items, zero-padded to [batch_size, *item_shape]."""
        buf = np.zeros((self.batch_size, *self.item_shape), self.dtype)
        for i, item in enumerate(items):
            buf[i] = item
        return buf

    def _loop(self) -> None:
        while not self._stop.is_set():
            pairs = self._collect()
            if not pairs:
                continue
            try:
                results = self.infer_fn(self._batch([i for i, _ in pairs]))
            except Exception as e:  # fan the error out to all waiters
                for _, fut in pairs:
                    fut.set_exception(e)
                continue
            for i, (_, fut) in enumerate(pairs):
                fut.set_result(results[i])
            self.stats["batches"] += 1
            self.stats["items"] += len(pairs)
            self.stats["padded_slots"] += self.batch_size - len(pairs)


class SpottingDecodeServer:
    """Cross-request continuous batching for an OmniParser seq decoder.

    A fixed pool of decode slots lives on the device. Every tick runs ONE
    ragged decode step for all slots together, each slot at its own
    absolute position (SeqDecoder.step_ragged) over its own encoder memory.
    New requests prefill in waves straight into free slots and finished
    slots free up at once, so there is no batch-formation barrier.

    Requests are `(memory [S,C], mem_pos [S,C], mem_valid [S],
    prompt_ids [P])`, the first three tensors on the model's device.
    Pages of mixed sizes share the pool within two budgets: a memory
    shorter than `mem_len` is zero-padded to it on the device, with
    `mem_valid` 0 (a -1e9 attention bias, so the padding contributes
    nothing), and a prompt may have up to `max_prompt_len` tokens (the KV
    cache holds max_prompt_len + max_steps + 1 positions); a refill wave
    takes requests of one prompt length. A budget left None latches from
    the first request, and a request beyond a budget fails its own Future.
    `submit` returns a Future resolving to the decoded token list (EOS
    excluded).
    """

    def __init__(self, model, task: str, mask_fn: Callable, n_slots: int,
                 max_steps: int, eos_id: Optional[int],
                 mem_len: Optional[int] = None,
                 max_prompt_len: Optional[int] = None):
        """mask_fn(pos_vec [n_slots], logits [n_slots, V]) → the logits
        the argmax reads (each slot's allowed classes at its position)."""
        self.model = model
        self.dec = getattr(model, f"{task}_decoder")
        self.device = model.input_proj.weight.device
        self.task = task
        self.n_slots = n_slots
        self.max_steps = max_steps
        self.eos_id = eos_id
        self.pad_id = model.vocab_layout.padding_index
        self._mask_fn = mask_fn
        self.mem_len = mem_len
        self.max_prompt_len = max_prompt_len
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._state = None
        self._slots: List[Optional[dict]] = [None] * n_slots
        self._pending: "deque" = deque()     # in-flight tick results
        self._backlog: "deque" = deque()     # validated+padded requests
        # refill-wave batch (co-queued requests prefilled per dispatch),
        # fixed so every prefill of one prompt length has one shape
        self.wave_size = min(n_slots, MAX_WAVE)
        self.stats = {"ticks": 0, "requests": 0, "occupied_slot_ticks": 0}

    # ---- lifecycle ----

    def start(self) -> "SpottingDecodeServer":
        if not self._started:
            self._worker.start()
            self._started = True
        return self

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
        if self._started:
            self._worker.join(timeout=10)

    def submit(self, memory, mem_pos, mem_valid, prompt_ids) -> Future:
        """memory/mem_pos/mem_valid stay on the device, so N requests can
        share one encoder-memory buffer. Prompts are host-side (they are
        stacked per refill wave)."""
        fut: Future = Future()
        self._q.put((memory, mem_pos, mem_valid, np.asarray(prompt_ids),
                     fut))
        return fut

    # ---- device work ----

    def _prefill(self, memory, mem_pos, mem_valid, prompt_ids, cache_len):
        dec = self.dec
        mem_kvs = dec.mem_kvs(memory, mem_pos)
        mem_bias = torch.where(mem_valid[:, None, None, :] > 0, 0.0, NEG)
        emb, qpos = self.model.embedding(prompt_ids, self.task)
        logits, caches = dec.prefill(emb, qpos, mem_kvs, mem_bias, cache_len)
        return logits[:, -1], caches, mem_kvs, mem_bias

    def _init_state(self, caches, mem_kvs, mem_bias, last_logits):
        def blank(a):
            return torch.zeros((self.n_slots,) + tuple(a.shape[1:]),
                               dtype=a.dtype, device=a.device)

        def blank_pairs(pairs):
            return tuple((blank(k), blank(v)) for k, v in pairs)

        return {
            "caches": blank_pairs(caches),
            "mem_kvs": blank_pairs(mem_kvs),
            "mem_bias": blank(mem_bias),
            "last_logits": blank(last_logits),
            "pos": torch.zeros((self.n_slots,), dtype=torch.long,
                               device=self.device),
            "finished": torch.ones((self.n_slots,), dtype=torch.bool,
                                   device=self.device),
        }

    def _insert(self, slot_idx, last_logits, caches, mem_kvs, mem_bias,
                pos0: int) -> None:
        """Scatter a WAVE of prefilled requests into slots slot_idx [k] in
        place. A wave padded to its fixed size repeats its last request and
        slot, so slot_idx holds duplicates; writing through repeated
        indices is safe only because the duplicate rows are identical."""
        st = self._state
        for dst, new in zip(st["caches"] + st["mem_kvs"], caches + mem_kvs):
            for d, n in zip(dst, new):
                d[slot_idx] = n.to(d.dtype)
        st["mem_bias"][slot_idx] = mem_bias.to(st["mem_bias"].dtype)
        st["last_logits"][slot_idx] = last_logits
        st["pos"][slot_idx] = pos0
        st["finished"][slot_idx] = False

    def _tick(self):
        """`burst` ragged decode steps for every slot → (tokens [T,
        n_slots], finished-before [T, n_slots]) on the device."""
        st = self._state
        cache_len = st["caches"][0][0].shape[1]
        toks, fins = [], []
        for _ in range(BURST_TICKS):
            logits = self._mask_fn(st["pos"], st["last_logits"])
            tok = torch.argmax(logits, -1).to(torch.int32)
            was_finished = st["finished"]
            finished = (was_finished if self.eos_id is None
                        else was_finished | (tok == self.eos_id))
            out_tok = torch.where(was_finished, self.pad_id, tok)
            emb, qpos = self.model.embedding.embed_at(out_tok[:, None],
                                                      self.task, st["pos"])
            new_logits, _ = self.dec.step_ragged(
                emb, qpos, st["caches"], st["pos"], st["mem_kvs"],
                st["mem_bias"])
            st["last_logits"] = new_logits[:, 0]
            st["pos"] = torch.clamp(st["pos"] + 1, max=cache_len - 1)
            st["finished"] = finished
            toks.append(out_tok)
            fins.append(was_finished)
        return torch.stack(toks), torch.stack(fins)

    # ---- worker ----

    def _prepare(self, req):
        """The request padded to the (mem_len, ≤ max_prompt_len) budget,
        latching each budget left None from the first request; None after
        failing its Future when it exceeds one."""
        memory, mem_pos, mem_valid, prompt_ids, fut = req
        S, P = memory.shape[0], prompt_ids.shape[0]
        if self.mem_len is None:
            self.mem_len = S
        if self.max_prompt_len is None:
            self.max_prompt_len = P
        if S > self.mem_len or P > self.max_prompt_len:
            fut.set_exception(ValueError(
                f"request (prompt_len={P}, mem_len={S}) exceeds the "
                f"server budget (max_prompt_len={self.max_prompt_len}, "
                f"mem_len={self.mem_len}) — construct the server with "
                f"larger budgets"))
            return None
        if S < self.mem_len:
            # zero rows with mem_valid 0, on the device (no sync)
            def pad(a):
                return torch.cat([a, a.new_zeros(
                    (self.mem_len - S,) + tuple(a.shape[1:]))])
            memory, mem_pos, mem_valid = (pad(memory), pad(mem_pos),
                                          pad(mem_valid))
        return memory, mem_pos, mem_valid, prompt_ids, fut

    def _insert_wave(self, wave, slots) -> None:
        """ONE batched prefill + ONE scatter insert for k co-queued
        requests of one prompt length. The wave is always padded to
        `wave_size` rows by repeating its last row and slot, so every
        prefill of a prompt length has one shape."""
        k = len(wave)
        kp = self.wave_size
        rows = list(wave) + [wave[-1]] * (kp - k)
        slot_idx = torch.as_tensor(list(slots) + [slots[-1]] * (kp - k),
                                   dtype=torch.long, device=self.device)
        memory, mem_pos, mem_valid = (torch.stack([r[j] for r in rows])
                                      for j in range(3))
        prompts = torch.from_numpy(np.stack(
            [r[3].astype(np.int32) for r in rows])).to(self.device)
        P = prompts.shape[1]
        cache_len = self.max_prompt_len + self.max_steps + 1
        last_logits, caches, mem_kvs, mem_bias = self._prefill(
            memory, mem_pos, mem_valid.float(), prompts, cache_len)
        if self._state is None:
            self._state = self._init_state(caches, mem_kvs, mem_bias,
                                           last_logits)
        self._insert(slot_idx, last_logits, caches, mem_kvs, mem_bias, P)
        for (_, _, _, _, fut), s in zip(wave, slots):
            self._slots[s] = {"future": fut, "tokens": [], "steps": 0}
            self.stats["requests"] += 1

    def _fill_slots(self) -> bool:
        """Move queued requests into free slots in batched waves.
        Returns False when the stop sentinel was consumed."""
        block = (not any(self._slots) and not self._pending
                 and not self._backlog)
        # drain the queue into the padded backlog (bounded lookahead so
        # a flood of requests can't starve the tick loop)
        while len(self._backlog) < 2 * self.n_slots:
            try:
                req = self._q.get(block=block, timeout=POLL_S)
            except queue.Empty:
                break
            block = False
            if req is None:
                return False
            prepared = self._prepare(req)
            if prepared is not None:
                self._backlog.append(prepared)
        # FIFO waves: the longest prefix of the backlog with one prompt
        # length, up to the free-slot count
        while None in self._slots and self._backlog:
            free = [i for i, s in enumerate(self._slots) if s is None]
            P = self._backlog[0][3].shape[0]
            wave = []
            cap = min(len(free), self.wave_size)
            while (self._backlog and len(wave) < cap
                   and self._backlog[0][3].shape[0] == P):
                wave.append(self._backlog.popleft())
            self._insert_wave(wave, free[:len(wave)])
        return True

    def _process(self, out_tok, was_finished, snapshot) -> None:
        """Host-side result handling for ONE dispatch — BURST_TICKS rows
        [T, n_slots], one dispatch behind the device (see _loop). The copy
        to the host is the wait."""
        toks = out_tok.cpu().numpy()
        fin = was_finished.cpu().numpy()
        for t in range(toks.shape[0]):
            self.stats["ticks"] += 1
            for i, slot in enumerate(snapshot):
                if slot is None:
                    continue
                if slot["future"].done():
                    # completed (by max_steps, or by EOS on an earlier
                    # burst row) while this lane kept ticking: discard
                    if self._slots[i] is slot:
                        self._slots[i] = None
                    continue
                self.stats["occupied_slot_ticks"] += 1
                done = False
                if fin[t, i]:
                    done = True      # EOS was consumed on a prior tick
                else:
                    tok = int(toks[t, i])
                    if self.eos_id is not None and tok == self.eos_id:
                        done = True
                    else:
                        slot["tokens"].append(tok)
                        slot["steps"] += 1
                        done = slot["steps"] >= self.max_steps
                if done:
                    slot["future"].set_result(slot["tokens"])
                    if self._slots[i] is slot:  # free (never reused before
                        self._slots[i] = None   # its dispatch was processed)

    def _run(self) -> None:
        with torch.inference_mode():
            self._loop()

    def _loop(self) -> None:
        """Tick pipeline, depth 2: the host's read of tick t's tokens
        overlaps with tick t+1 already queued on the device. A slot
        finishing at tick t is therefore reused one tick later than a
        synchronous loop would reuse it. Ticks on finished slots emit pad
        tokens into `finished`-masked lanes, so late processing never
        corrupts results."""
        while not self._stop.is_set():
            try:
                if not self._fill_slots():
                    return
                if any(self._slots):
                    out_tok, was_finished = self._tick()
                    self._pending.append((out_tok, was_finished,
                                          list(self._slots)))
                # keep at most one dispatch in flight while slots are live;
                # drain fully when the pool is idle
                keep = 1 if any(self._slots) else 0
                while len(self._pending) > keep:
                    self._process(*self._pending.popleft())
            except Exception as e:
                # fan the failure to every waiter instead of killing the
                # worker silently, and reset to an empty pool
                for s in self._slots:
                    if s is not None and not s["future"].done():
                        s["future"].set_exception(e)
                for r in self._backlog:
                    if not r[4].done():
                        r[4].set_exception(e)
                self._slots = [None] * self.n_slots
                self._backlog.clear()
                self._pending.clear()
                self._state = None


class SpottingService:
    """Full OmniParser text spotting as a continuously batched service.

    Wires the three decode stages the reference runs as sequential
    per-request loops (transformer.py:235-289) through slot-based
    cross-request servers: a batched encoder, a `pt` server with the
    coordinate/eos parity mask, then per-INSTANCE polygon and recognition
    requests fanned into `poly`/`rec` servers. Unlike `infer_spotting`
    (which pads to max_instances), the service decodes exactly the
    detected instances, and instances from different pages share ticks.

    The service keeps its own copy of `model` on `device` (the GPU unless
    `device="cpu"`), with its Linear and conv weights cast to the compute
    dtype once. `submit(image)` → Future of {"points": [N,2] bin tokens,
    "polygons": [N, poly_length] bins, "rec_tokens": [N, list]}.
    """

    def __init__(self, model, device: Union[str, torch.device, None] = None,
                 n_slots: int = 8, encode_batch: int = 4,
                 mem_len: Optional[int] = None):
        """n_slots: the pt server's slots (the poly and rec servers have
        4 × n_slots).

        mem_len: the encoder-memory budget for mixed page sizes: a smaller
        page's memory is padded into it (SpottingDecodeServer mem_len);
        None latches the first page's.

        encode_batch: pages submitted together share ONE batched encoder
        forward; a page waits up to BATCH_WAIT_MS for co-travelers. That
        batcher takes the first page's shape and `submit` rejects another,
        so mixed page sizes take encode_batch=1: each page is then encoded
        alone, at its own shape, on the submitting thread."""
        self.device = resolve_device(device)
        self.model = cast_matmul_weights(
            copy.deepcopy(model).to(self.device).eval(),
            model.policy.compute_dtype)
        self.model.requires_grad_(False)
        c = self.cfg = self.model.config
        v = self.vocab = c.vocab()
        self._encode_batch = max(1, int(encode_batch))
        self._encode_batcher: Optional[ContinuousBatcher] = None
        self._encode_lock = threading.Lock()

        pt_prompt = v.pt_prompt(c.use_char_window_prompt)
        self._pt_prompt = pt_prompt
        P_pt = len(pt_prompt)
        ids = torch.arange(v.num_classes, device=self.device)
        coord = ids < c.num_bins
        coord_or_eos = coord | (ids == v.pt_eos_index)

        def pt_mask(pos, logits):
            # step parity relative to the prompt end (infer_spotting's pt
            # mask): even steps may emit coords or EOS, odd steps coords
            even = ((pos - P_pt) % 2 == 0)[:, None]
            allow = torch.where(even, coord_or_eos[None], coord[None])
            return torch.where(allow, logits, NEG)

        def fixed_mask(allow):
            return lambda pos, logits: torch.where(allow[None], logits, NEG)

        # infer_spotting's poly and rec masks
        rec_allow = ((ids >= c.num_bins) & (ids <= v.rec_eos_index)
                     & (ids != v.pt_eos_index) & (ids != v.poly_eos_index))
        m = self.model
        self.pt_server = SpottingDecodeServer(
            m, "pt", pt_mask, n_slots, c.pt_seq_length, v.pt_eos_index,
            mem_len=mem_len)
        self.poly_server = SpottingDecodeServer(
            m, "poly", fixed_mask(coord), 4 * n_slots, c.poly_length, None,
            mem_len=mem_len)
        self.rec_server = SpottingDecodeServer(
            m, "rec", fixed_mask(rec_allow), 4 * n_slots, c.rec_length,
            v.rec_eos_index, mem_len=mem_len)
        self._started = False

    def start(self) -> "SpottingService":
        if not self._started:
            self.pt_server.start()
            self.poly_server.start()
            self.rec_server.start()
            self._started = True
        return self

    def stop(self) -> None:
        if self._encode_batcher is not None:
            self._encode_batcher.stop()
        self.pt_server.stop()
        self.poly_server.stop()
        self.rec_server.stop()

    def _encode(self, images: np.ndarray):
        with torch.inference_mode():
            return self.model.encode(torch.from_numpy(images).to(self.device))

    def _encode_page(self, image: np.ndarray) -> Future:
        """Future of (memory, mem_pos, mem_valid) for one page, on the
        device: encoded alone when encode_batch is 1, else through the
        shared batched encoder, made for the first page's shape. The page
        memory never leaves the device: the decode servers prefill from
        it, and every per-instance request references it."""
        image = np.asarray(image, np.float32)
        if self._encode_batch == 1:
            memory, mem_pos, mem_valid = self._encode(image[None])
            fut: Future = Future()
            fut.set_result((memory[0], mem_pos[0], mem_valid[0]))
            return fut
        with self._encode_lock:
            if self._encode_batcher is None:
                def run(batch):
                    memory, mem_pos, mem_valid = self._encode(batch)
                    return [(memory[i], mem_pos[i], mem_valid[i])
                            for i in range(batch.shape[0])]

                self._encode_batcher = ContinuousBatcher(
                    run, self._encode_batch, image.shape,
                    max_wait_ms=BATCH_WAIT_MS, dtype=np.float32).start()
        return self._encode_batcher.submit(image)

    def submit(self, image: np.ndarray) -> Future:
        """image [H, W, 3] (normalized float) → Future of the spotting
        result dict. The encode rides the shared batched encoder and the
        pt→poly/rec fan-out runs in callbacks, so many pages can be in
        flight at once."""
        result: Future = Future()
        enc_fut = self._encode_page(image)

        def on_encoded(fut: Future) -> None:
            try:
                memory, mem_pos, mem_valid = fut.result()
            except Exception as e:
                result.set_exception(e)
                return
            pt_fut = self.pt_server.submit(
                memory, mem_pos, mem_valid,
                np.asarray(self._pt_prompt, np.int32))
            pt_fut.add_done_callback(
                lambda f: self._on_pt(f, memory, mem_pos, mem_valid, result))

        enc_fut.add_done_callback(on_encoded)
        return result

    def _on_pt(self, fut: Future, memory, mem_pos, mem_valid,
               result: Future) -> None:
        """pt decode finished → fan each detected instance into the
        poly/rec servers; resolve `result` when all children land."""
        v = self.vocab
        try:
            toks = [t for t in fut.result() if t != v.pt_eos_index]
            pts = [(toks[i], toks[i + 1])
                   for i in range(0, len(toks) - 1, 2)]
            pts = pts[: self.cfg.max_instances]
            if not pts:
                result.set_result({"points": np.zeros((0, 2), np.int32),
                                   "polygons": [], "rec_tokens": []})
                return
            poly_futs, rec_futs = [], []
            for (x, y) in pts:
                poly_prompt = np.asarray([x, y, v.poly_sos_index], np.int32)
                rec_prompt = np.asarray([x, y, v.rec_sos_index], np.int32)
                poly_futs.append(self.poly_server.submit(
                    memory, mem_pos, mem_valid, poly_prompt))
                rec_futs.append(self.rec_server.submit(
                    memory, mem_pos, mem_valid, rec_prompt))

            remaining = {"n": 2 * len(pts)}
            lock = threading.Lock()

            def on_child(_):
                with lock:
                    remaining["n"] -= 1
                    if remaining["n"]:
                        return
                try:
                    result.set_result({
                        "points": np.asarray(pts, np.int32),
                        "polygons": [f.result() for f in poly_futs],
                        "rec_tokens": [f.result() for f in rec_futs],
                    })
                except Exception as e:
                    result.set_exception(e)

            for f in poly_futs + rec_futs:
                f.add_done_callback(on_child)
        except Exception as e:
            result.set_exception(e)

    def __call__(self, images: Sequence[np.ndarray],
                 timeout: float = 600.0) -> List[dict]:
        futs = [self.submit(im) for im in images]
        return [f.result(timeout=timeout) for f in futs]

    @property
    def occupancy(self) -> dict:
        """Slot occupancy per stage: occupied_slot_ticks / (ticks*slots)."""
        out = {}
        for name, srv in (("pt", self.pt_server), ("poly", self.poly_server),
                          ("rec", self.rec_server)):
            t = srv.stats["ticks"] * srv.n_slots
            out[name] = srv.stats["occupied_slot_ticks"] / t if t else 0.0
        return out
