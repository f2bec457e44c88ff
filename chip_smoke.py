#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # on a machine with a card
    python3 chip_smoke.py --cpu-rehearsal # tiny sizes, plain versions, CPU

Phases, each fatal on failure:
  1. the card: nvidia-smi name and power limit, device name and count;
  2. build the kernels from the five sources in src/repro_torch/csrc, one
     nvcc per source, all at once (ptxas registers and spills of every
     kernel; registers, local bytes and shared memory of each instance of
     both flash_attention routes, without and with probs_bf16, as the card
     reports them, and the count
     of tensor-core instructions in the float32 route's SASS, from
     cuobjdump);
  3. kernel phase: a short probe of the paths records each kernel's
     largest call (ragged_slots takes the inputs of the extensions path's
     first pack_rows call, histogram the bins of its largest
     multi_bin_offsets call: no path reaches either, as in the JAX
     package); each kernel is held against its plain PyTorch version
     on those inputs (bit equality: every output is integer) and timed
     beside its plain version, its bound and, where one exists, one
     PyTorch call computing the same function; flash_attention is held
     against its plain version on twenty cases (the serving path's prefill
     call, the MoE path's (arctic's 56 query heads over 8, 1024 tokens),
     gemma3-4b's (8 query heads over 4 at D=320, 2048 tokens, a 1024-key
     window), D=320 with a window, D=256, Tq=1 < Tk, non-causal with a ragged key
     tile: the bf16 wgmma route; float32, the 3xTF32 route
     flash_attention_f32: the kernel-phase call at D=128, D=16 at 2048
     tokens, D=320 with a window, and the float32 serve phase's prefill
     call, 4 slots of 32 tokens at D=16, without and with its 16-key
     window; then deepseek-v3's MLA prefill call (128 heads, 1024 tokens,
     D=192 with V's 128 columns zero-padded to 192, as mla_attention pads
     them), the same with probs_bf16 (the bf16 route's instance without
     the P_lo pass), and the float32 kernel-phase call with probs_bf16
     (one exact TF32 P V pass), and zamba2-7b's shared-attention prefill
     call (32 heads of D=112, 2048 tokens: the D<=128 bf16 instance on its
     operands as they are, no padded copy), and the frontend cells' four
     calls: seamless-m4t-medium's encoder (non-causal over 512 frames),
     its cross-attention (non-causal, 2048 queries over 512 keys: Tq > Tk)
     and its decoder (causal), all 16 heads of D=64, and internvl2-76b's
     prefill (64 query heads over 8 at D=128, 2048 positions)) elementwise
     (bf16 within one ulp of each element, float32 at 3e-5;
     attention_close; a probs_bf16 call also 2**-8 of the attention-weighted
     mean of |V|, since each side rounds P against its own running max, so
     each call's launched instance is read back and must carry its flag,
     and a flagged output must differ from the same kernel's unflagged one),
     each route's row, the MoE and gemma paths' cases and the new three
     timed beside scaled_dot_product_attention (a boolean mask for the
     window; their ratio printed; the MLA case also beside it on V at its
     real 128 columns), the MLA cases' bound reckoned on the real work
     (Dv = 128); a fixed
     large-bin bin_offsets case (2**24 items into 2**20 bins, past one
     launch of its kernel: the bin_csr route) held bit for bit; the wire
     split: bin_offsets and pack_rows held bit for bit and timed at their
     kernel-phase call and at the extensions path's wave call (2**19
     items, where most of their launches are), with the device ms and
     launches of each kernel they run (torch.profiler); the csr split:
     bin_csr held bit for bit and timed at its kernel-phase call and at an
     extensions wave's CSR (2**19 items into 2**20 blocks), with the
     device ms and launches of each kernel it runs, beside
     torch.sort(stable=True) of its int32 key; each
     hash probe's time split on the card (torch.profiler device time by
     role: the CSR, the probe kernel, copies, the rest), with its CSR
     timed beside that stable sort and the bincount + int64 argsort the
     first wrapper ran; find_arrivals' two
     routes (block-major, one warp per query) timed at 1/8 to 8 queries
     a block, on either side of the density that picks between them;
  4. hash-map path: a 2**26-bucket hash map (block 64, u32 keys and
     values) takes 4 insert waves of 2**23 keys (one wave with ~1%
     duplicates), a speculative find of 2**23 keys (half absent) and a
     find_insert of 2**22 + 2**22;
  5. genomics path (paper section 9.2): reads of a 2**21-base genome
     (coverage 8, 1% errors) give 13.4 M 21-mers, packed on the card; a
     2**28-bit Bloom filter pre-pass, k-mer counting into a 2**25-bucket
     table, the de Bruijn table of the solid extensions built twice
     (direct insert, and HashMapBuffer insert + flush), a local find of
     every extension and as many absent keys, and 2**16 walks of 64
     steps;
  6. extensions path, at the hash-map path's width (2**26 buckets, block
     64): an integrity-checked insert of 2**23 keys (capacity 2**20, 8
     retry rounds) over a wire whose round-0 window is corrupted, the
     heal of the unacked 2**20 and a find of all keys, a degraded insert
     with rank 0 dead, the same inserts and a speculative find of 2**23
     keys over the hierarchical and the dense transport, and a
     split-phase find_insert of 2**22 + 2**22 over the hierarchical
     transport against the synchronous one;
  7. dedup path (data/dedup.py): the port's TokenStream (vocab 151,936,
     qwen3-4b's tokenizer width) gives 8 batches of 4096 documents of 2048
     tokens, from the second on 1/8 of each batch verbatim copies of
     earlier documents and 1/8 an earlier document's first half with a
     fresh second half; a Deduper (ngram 8, a 2**31-bit Bloom filter, a
     2**26-slot count table) observes each batch (2**23 shingles), then
     observe_and_probe takes a fresh batch and a probe of 1024 documents
     (half held out, half observed), then count_of reads 256 planted
     copies.  The oracle is exact, made from the stream with the JAX
     package's numpy uint64 shingling (ingest order is stream order at
     P=1): no shingle that occurred earlier reads unseen, the excess
     stays within twice the rate that a model of the blocked scheme
     (uniform block, k bits in arithmetic progression mod 64) gives for
     the filter's fill before and after each batch, verbatim copies rate
     1.0 and are flagged, the probe's observed half reads 1.0 and its
     held-out half only what occurred (up to twice the model's rate for
     the final filter), and count_of equals 1 + the landed insertions of each
     shingle (its sightings but where an excess or a failed insert
     explains the gap); the launches are exactly its eight kernels; then
     one observe's device ms by role (torch.profiler) and the device-busy
     share of its wall time;
  8. serving path: qwen3-4b at full width and depth (36 layers, 4.02 B
     parameters in bf16 from the port's seeded init_params) serves 16
     requests of 2048-token prompts in slots of 8, 32 greedy tokens each,
     through repro_torch.launch.serve.serve: prefill attention runs the
     bf16 flash_attention kernel (36 launches a wave, none of the float32
     route), decode the plain
     matmuls; the first layer's attention output on wave 0's prompts
     (lm.forward of the model cut to one layer) is held kernel vs plain
     at LAYER_REL_L2, and two faults planted around the kernel's wrapper
     must each break that check; then gemma3-4b the same way at full width
     and depth (34 layers, 29 of them windowed at 1024 keys, head_dim 320,
     4.01 B parameters): once with window_cache off and once on (the
     second's kernel run fed the first's tokens: every prefill's logits
     bit for bit, every decode step's within SERVE_REL_L2), and the first
     (windowed) layer's float32 decode attention over the ring held
     against the full cache's on the same contents at RING_REL_L2 for 4
     steps, with two ring faults planted in the decode append (write
     index off by one, append skipped) that must each break it;
  9. MoE serving path: arctic-480b at full width (d_model 7168, 56 query
     heads over 8, 128 experts top-2 of d_ff 4864 beside a dense residual
     MLP, bf16 with a float32 router) cut to 2 of its 35 layers (27.7 B
     parameters from the seed, drawn expert by expert) serves 16 requests
     of 1024-token prompts in slots of 8, 16 greedy tokens each, through
     serve on a SerialBackend: each layer's expert dispatch rides the
     exchange (bin_offsets, pack_rows, place_rows: their largest calls,
     captured on one prefill, held bit for bit and timed beside their
     bounds first), the prefill attention the bf16 flash_attention; the
     launches are counted exactly; each MoE layer's call on wave 0's
     prefill and first decode step equals moe_apply on its input with the
     plain versions bit for bit (y, aux, expert_load, drops, routing), and
     a wire fault planted after pack_rows (two send slots swapped) must
     break that; every logits row of the teacher-forced plain run within
     SERVE_REL_L2, but for rows a near-tie routing flip (margin below
     FLIP_MARGIN) sent another way; then the device time of one prefill
     wave and one decode step by role (torch.profiler);
  9b. deepseek-v3 serving path: deepseek-v3-671b at full width (d_model
     7168, 128 heads of MLA: q_lora 1536, kv_lora 512, nope 128, rope 64,
     v 128; 256 experts top-8 of d_ff 2048 with one shared expert and
     sigmoid + bias routing; vocab 129,280 padded to 129,536, an untied
     head; bf16 with a float32 router; the MTP head carried, unused in
     serving) cut to 4 of its 61 layers, the three first_k_dense layers
     (d_ff 18432) and one MoE layer (15.8 B parameters; the whole model's
     exact and active counts printed beside the cut's), with the MoE
     path's traffic and checks (a prefill wave's dispatch is one plan of
     65,536 rows of 7,170 words); served with mla_absorb off and then on,
     the second's kernel run fed the first's tokens: every prefill's
     logits bit for bit, every decode step's within SERVE_REL_L2; the
     first layer's prefill attention kernel vs plain at LAYER_REL_L2, and
     the two planted flash faults must each break it; the first layer's
     float32 decode attention on the same cache contents for 4 steps, per
     (request, head), absorbed vs expanded (K and V rounded to bf16 by the
     expansion) within LAYER_REL_L2 (mla_cp_decode selects the absorbed
     form on one rank), and two faults planted in the absorbed form (the
     rope term dropped from the score; the W_uk / W_uv split shifted by
     one column) must each break it; then the device time of one prefill wave and one
     decode step by role (MLA projections, K/V expansion, flash, decode
     attention, router, the wire kernels, expert bmm, shared expert, dense
     MLP, the rest) with mla_absorb off and on, and the cell's seconds;
  9c. the recurrent serving cells, each at full width and depth in bf16
     with the qwen3-4b cell's traffic: zamba2-7b (81 layers, 68 Mamba2 and
     13 shared-attention layers `mmmmma`, d_model 3584, d_state 64, 32
     heads of 112; 5.62 B parameters) and rwkv6-1.6b (24 RWKV-6 layers,
     d_model 2048, head 64; 1.58 B): serve with the kernels (each mixer's
     scan one launch a layer and call, counted by kernel: Mamba2's chunked
     mamba_scan at the 2048-token prefills and its sequential
     mamba_scan_seq at decode, rwkv_scan at both; the shared attention's
     prefill the bf16 flash route; launches counted exactly)
     and the plain run teacher-forced, logits within SERVE_REL_L2, the
     state carry (decode step 1 and gen against a prefill of the prompt
     and the tokens) within SERVE_REL_L2; the first mixer layer's scan
     calls of wave 0 (its prefill call, the largest, and its first decode
     call) held kernel vs plain, output and final state, within
     SCAN_REL_L2 (rwkv_scan's states and mamba_scan_seq's bit for bit),
     each call held to one launch of the kernel its shape picks, its row
     naming that kernel and route, timed beside the plain
     loop, the bound (the chunked route's products at three TF32 passes
     on the tensor cores, or the bytes; the sequential form's CUDA-core
     figure beside it) and the wrapper's host microseconds a call, with
     planted faults (the decay applied after the update; RWKV's bonus
     dropped) that must break that check by FAULT_FACTOR; then the device
     time of one prefill wave and one decode step by role (in/out projections, scan
     kernel, mixer glue, shared attention, flash, MLP, channel mix, head,
     the rest);
  9d. the frontend cells, in bf16 with the qwen3-4b cell's slots and
     tokens, prompts and embeddings drawn as data.tokens.synth_batch draws
     a prefill batch of 2048 positions: seamless-m4t-medium at full width
     and depth (12 encoder and 12 decoder layers, d_model 1024, 16 heads
     of 64, d_ff 4096 GELU, vocab 256,206 untied; 0.88 B parameters), each
     request's 512 source frames encoded at its wave's prefill, and
     internvl2-76b at full width (d_model 8192, 64 query heads over 8,
     d_ff 28672, vocab 128,256) cut to 8 of its 80 layers (8.9 B
     parameters), 256 patch embeddings before 1,792 text tokens: serve
     with the kernels (the bf16 flash route once per flash call and wave:
     seamless's encoder layers, decoder layers and cross-attentions) and
     the plain run teacher-forced, logits within SERVE_REL_L2, decode
     against a prefill of the same tokens within SERVE_REL_L2; the first
     encoder layer's attention and the first decoder layer's
     cross-attention (internvl: the first layer's attention) held kernel
     vs plain at LAYER_REL_L2 on the inputs the kernel run gave them, a
     causal encoder planted around ops.flash_attention must break it; the
     first layer's attention at decode over the prefill's cache (seamless:
     the cross-attention over xk/xv) held against the same call in a
     prefill of one more token, on the same input row, at LAYER_REL_L2,
     with planted faults that must each break it (the cross K/V left zero
     at prefill, the JAX package's behaviour; rotary applied to the
     cross-attention's q and k; positions restarted at the first text
     token); then the device time of one prefill wave and one decode step
     by role (encoder, attention projections, flash, cross decode, decode
     attention, MLP, the rest);
  10. float32 serve phase: repro_torch.launch.serve.main, as a user runs
     it, with the JAX package's own float32 configurations (--arch
     qwen3-4b --reduced, gemma3-4b --reduced, whose local layers carry a
     16-key window, arctic-480b --reduced, whose MoE layers dispatch
     over the exchange, deepseek-v3-671b --reduced, MLA at D=24 with V
     padded from 16 and MoE, zamba2-7b --reduced, five Mamba2 layers and a
     shared-attention one, and rwkv6-1.6b --reduced), and
     seamless-m4t-medium and internvl2-76b --reduced through serve(...)
     with their embeddings at serve.py's defaults (the CLI serves tokens
     only): its prefills run flash_attention_f32 once per flash call
     and wave and never the
     bf16 route, the scans once per mixer layer and call (the MoE models'
     dispatch also launches the wire kernels, counted exactly); each
     flash call of wave 0's prefill, captured as the run made
     it, is held against the plain version on its inputs elementwise at
     3e-5 (attention_close); a plain run of the same model and prompts,
     teacher-forced with its tokens, gives logits within F32_SERVE_REL_L2
     of it at every step; a control run with Q, K and V rounded to TF32
     before the kernel (one TF32 pass) must break both checks; for the
     recurrent models the state carry (a prefill and a decode step against
     a prefill of one more token) holds within F32_SERVE_REL_L2, and a
     fault planted at decode (the conv state zeroed; RWKV's prev dropped)
     must break it by FAULT_FACTOR; so do seamless's cross carry and
     internvl's decode after the patches, with the frontend cells' faults;
  11. multi-rank cells: qwen3-4b at full width and depth (8 of its cell's
     2048-token prompts, 32 tokens) and deepseek-v3-671b at full width, 4
     of 61 layers, mla_absorb and mla_cp_decode, one MoE row per (token,
     owner rank) (8 of its cell's 1024-token prompts, 16 tokens), each served first on one rank in this process (the
     reference: tokens, every step's logits, the first layer's output at
     prefill and decode), then by MR_RANKS processes on the one card,
     (data 1, model 4) over gloo on localhost (NCCL takes no two ranks of
     one communicator on one device; gloo's collectives go through host
     memory, so the times are not a multi-card figure), each rank drawing
     its slice of the same seeded model and serving the wave through
     serve(..., layout=...), teacher-forced with the one-rank tokens:
     every rank's greedy picks the same at every step, logits within
     SERVE_REL_L2 of the one-rank run's, the first layer within
     MR_LAYER_REL_L2 relative L2 at prefill and decode, its largest
     per-position gap within MR_PREFILL_POSITION_GAP at prefill and
     LAYER_REL_L2 at decode (a vocab shard read one row off, the psum
     after wo skipped and, for deepseek, the CP combine without its
     exp(m_i - M) rescale planted must each break it), each rank's
     parameter bytes what shard_params gives it, each rank's launches of
     flash_attention and the MoE wire kernels as reckoned from the
     config, no MoE copy dropped on the wire; for deepseek the first
     prefill and decode MoE calls as served (four destinations) equal
     moe_apply on the same input and layout with the plain versions bit
     for bit (y, expert loads, drops; two send slots swapped after
     pack_rows planted must break it), every expert whose served copies
     differ from the one-rank run's (bin overflows, printed) has a copy
     moved onto or off it by a token whose top-k set changed at a margin
     below FLIP_MARGIN, and the first MoE layer's output at a decode
     shape the same on every rank, where every rank dispatching every
     token (the JAX package's T % P != 0 path) planted must break it;
     per rank: TTFT, decode ms a step, peak memory and the last decode
     step's device-busy share.
Each path runs through the port's entry points (the containers on a
SerialBackend), with the kernels (launch counts reset just before, read
just after) and with the plain versions; the two runs must pass the
path's oracle, computed on the card, and agree: bit for bit on the
integer paths; on the serving path the plain run is teacher-forced with
the kernel run's tokens and every prefill's and decode step's logits
agree within a relative L2 error of SERVE_REL_L2.
The last line is {"ok": true, "device": {...}}; the line before it the
nvidia-smi name and power limit; before that the kernels' JSON line.
Without a CUDA device (and without --cpu-rehearsal) it exits 1.
Float32 matmuls run in full float32 (TF32 off for matmuls and cuDNN), and
bf16 matmuls reduce in float32 (no reduced-precision split-K reduction).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.append(str(ROOT / "scripts"))   # kernel_ab: the host-time helper the A/B scripts share

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# the port; a lone copy of this script fails here
from repro_torch.containers import bloom as bl  # noqa: E402
from repro_torch.containers import hashmap as hm  # noqa: E402
from repro_torch.containers import hashmap_buffer as hb  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.core.backend import SerialBackend  # noqa: E402
from repro_torch.core.exchange import CommittedPlan, ExchangePlan  # noqa: E402
from repro_torch.core.faults import FaultInjectingTransport, FaultSpec  # noqa: E402
from repro_torch.core.transport import DENSE  # noqa: E402
from repro_torch.core.hashing import fmix32  # noqa: E402
from repro_torch.core.object_container import Spec  # noqa: E402
from repro_torch.core.promises import ConProm  # noqa: E402
from repro_torch.core.u32 import as_u64, to_i32  # noqa: E402
from repro_torch.data import Deduper, DedupSpec, TokenStream, synth_batch  # noqa: E402
from repro_torch.data import genomics as gen  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.kernels import binning, bloom_kernel, build, hash_probe, ssm_scan  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ops import MODE_ADD  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from kernel_ab import host_us  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
OPS_PER_S = 67e12           # H100 SXM 32-bit rate outside the tensor cores (float32)
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate

FULL = dict(capacity=1 << 26, block=64, wave=1 << 23, waves=4, find=1 << 23,
            fi=1 << 22, reps=10, large_bins=(1 << 24, 1 << 20))
REHEARSAL = dict(capacity=1 << 12, block=64, wave=1 << 9, waves=4, find=1 << 9,
                 fi=1 << 8, reps=2, large_bins=(1 << 12, 1 << 11))
# genomics path: benchmarks/kmer.py's K, coverage and error rate;
# meraculous.py's two build arms and its walk
G_FULL = dict(genome_len=1 << 21, k=21, bloom_bits=1 << 28, bloom_k=4, table=1 << 25,
              block=64, probes=1 << 22, walks=1 << 16, steps=64)
G_REHEARSAL = dict(genome_len=1 << 12, k=21, bloom_bits=1 << 16, bloom_k=4,
                   table=1 << 15, block=64, probes=1 << 8, walks=1 << 6, steps=8)
# extensions path: micro_hashmap's faults arm at the hash-map path's width,
# with retry rounds so a fault costs one window; the hierarchical hop lane
# holds ranks below 2**20 per (src, dst) bucket, so its ops run in waves
X_FULL = dict(capacity=1 << 26, block=64, n=1 << 23, cap=1 << 20, rounds=8,
              wave=1 << 19, fi=1 << 22)
X_REHEARSAL = dict(capacity=1 << 14, block=64, n=1 << 12, cap=1 << 9, rounds=8,
                   wave=1 << 8, fi=1 << 10)
# dedup path: the port's TokenStream at qwen3-4b's tokenizer width, 8 observe
# batches of 4096 documents (2**23 shingles a batch at ngram 8, the hash-map
# path's waves), a 2**31-bit filter (256 MB) and that path's 2**26-slot table
D_FULL = dict(vocab=151936, seq_len=2048, docs=4096, batches=8, ngram=8, nbits=1 << 31,
              table=1 << 26, threshold=0.5, rounds=1, probe=1024, planted=256, sample=1 << 16)
D_REHEARSAL = dict(vocab=151936, seq_len=64, docs=64, batches=4, ngram=8, nbits=1 << 19,
                   table=1 << 12, threshold=0.5, rounds=1, probe=64, planted=8, sample=1 << 12)
# serving path: serve.py's loop and flags at a chat-sized prompt
V_FULL = dict(arch="qwen3-4b", reduced=False, requests=16, batch=8, prompt_len=2048, gen=32)
V_REHEARSAL = dict(arch="qwen3-4b", reduced=True, requests=4, batch=2, prompt_len=40, gen=4)
# the windowed serving path: gemma3-4b at full width and depth, prompts past its
# 1024-key window, served with window_cache off and then on
W_FULL = dict(arch="gemma3-4b", reduced=False, requests=16, batch=8, prompt_len=2048, gen=32)
W_REHEARSAL = dict(arch="gemma3-4b", reduced=True, requests=4, batch=2, prompt_len=40, gen=4)
# MoE serving path: arctic-480b at full width, cut to 2 of its 35 layers (13.6 B
# parameters a layer: a third would not fit 80 GB), 1024-token prompts of its 4096
M_FULL = dict(arch="arctic-480b", reduced=False, layers=2, requests=16, batch=8,
              prompt_len=1024, gen=16)
M_REHEARSAL = dict(arch="arctic-480b", reduced=True, layers=2, requests=4, batch=2,
                   prompt_len=24, gen=4)
# deepseek-v3 serving path: full width, cut to 4 of its 61 layers (the three
# first_k_dense layers and one MoE layer: ~15.8 B parameters; a second MoE layer
# adds 11.5 B), arctic's traffic
DS_FULL = dict(arch="deepseek-v3-671b", reduced=False, layers=4, requests=16, batch=8,
               prompt_len=1024, gen=16)
DS_REHEARSAL = dict(arch="deepseek-v3-671b", reduced=True, layers=2, requests=4, batch=2,
                    prompt_len=24, gen=4)
# the recurrent serving cells at full width and depth, the qwen3-4b cell's
# traffic: zamba2-7b (68 Mamba2 layers, 13 shared-attention layers) and rwkv6-1.6b
SSM_FULL = (dict(arch="zamba2-7b", reduced=False, requests=16, batch=8, prompt_len=2048, gen=32),
            dict(arch="rwkv6-1.6b", reduced=False, requests=16, batch=8, prompt_len=2048, gen=32))
SSM_REHEARSAL = (dict(arch="zamba2-7b", reduced=True, requests=4, batch=2, prompt_len=40, gen=4),
                 dict(arch="rwkv6-1.6b", reduced=True, requests=4, batch=2, prompt_len=40, gen=4))
# the frontend cells, drawn as data.tokens.synth_batch draws a prefill batch of
# `seq` positions: seamless-m4t-medium at full width and depth, qwen3-4b's traffic
# plus each request's seq // 4 = 512 source frames (configs/shapes.py); internvl2-76b
# at full width, cut to 8 of its 80 layers (8.9 B parameters, 17.9 GB in bf16: the
# whole model, 76 B, does not fit one 80 GB card), 256 patches + 1,792 text tokens
FRONTEND_FULL = (dict(arch="seamless-m4t-medium", reduced=False, layers=None, requests=16,
                      batch=8, seq=2048, gen=32),
                 dict(arch="internvl2-76b", reduced=False, layers=8, requests=16, batch=8,
                      seq=2048, gen=32))
FRONTEND_REHEARSAL = (dict(arch="seamless-m4t-medium", reduced=True, layers=None, requests=4,
                           batch=2, seq=40, gen=4),
                      dict(arch="internvl2-76b", reduced=True, layers=None, requests=4, batch=2,
                           seq=40, gen=4))
#: relative L2 error allowed between two bf16 runs' logits.  Two bf16
#: computations of the 36-layer model that differ in any rounding drift
#: apart to ~2.3e-2 (kernel vs plain prefill with identical GEMMs, the
#: plain decode vs the plain prefill), so this check sees only large faults
SERVE_REL_L2 = 5e-2
#: largest per-position relative L2 gap allowed between the first layer's
#: attention outputs through the kernel and through the plain version:
#: there they differ only by the kernel's rounding, before the drift above
LAYER_REL_L2 = 5e-3
#: largest relative L2 gap allowed, per (request, head) and decode step,
#: between a windowed layer's decode attention (float32) over the ring
#: (window_cache) and over the full cache with the same contents: the two
#: sum the same keys' softmax in another order, so they differ by float32
#: rounding (~1e-7); one key of the window lost or swapped moves it by ~1e-2
RING_REL_L2 = 1e-4
#: attention in bf16: both versions accumulate in float32 and round once,
#: so an element differs by at most one bf16 ulp of its own size (2**-7
#: of it) plus float32 summation noise (~1e-6)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
#: probs_bf16: the kernel rounds each probability to bf16 against its running
#: max, the plain version against the row's max (each at most 2**-9 of it),
#: so an element may move by 2**-8 of the attention-weighted mean of |V|
PROBS_BF16_RTOL = 2.0 ** -8
# flash_attention's kernel-phase cases: (b, hq, hkv, tq, tk, d, causal, window, dtype);
# the first is the serving path's prefill call, the one its JSON row reports
BF16, F32 = torch.bfloat16, torch.float32
FLASH_FULL = {
    "serving_prefill": (8, 32, 8, 2048, 2048, 128, True, 0, BF16),
    "arctic_prefill": (8, 56, 8, 1024, 1024, 128, True, 0, BF16),
    "gemma_prefill": (8, 8, 4, 2048, 2048, 320, True, 1024, BF16),
    "d320_window": (2, 8, 4, 2048, 2048, 320, True, 1024, BF16),
    "d256": (4, 16, 8, 2048, 2048, 256, True, 0, BF16),
    "suffix_tq1": (8, 32, 8, 1, 2048, 128, True, 0, BF16),
    "noncausal_ragged": (2, 8, 8, 1000, 1000, 128, False, 0, BF16),
    "f32": (2, 16, 4, 777, 777, 128, True, 0, F32),
    "f32_d16": (4, 16, 4, 2048, 2048, 16, True, 0, F32),
    "f32_d320_window": (2, 8, 4, 2048, 2048, 320, True, 1024, F32),
    "f32_serve_prefill": (4, 4, 4, 32, 32, 16, True, 0, F32),
    "f32_serve_prefill_window": (4, 4, 4, 32, 32, 16, True, 16, F32),
    "deepseek_prefill": (8, 128, 128, 1024, 1024, 192, True, 0, BF16),
    "deepseek_prefill_probs_bf16": (8, 128, 128, 1024, 1024, 192, True, 0, BF16),
    "f32_probs_bf16": (2, 16, 4, 777, 777, 128, True, 0, F32),
    "zamba2_prefill": (8, 32, 32, 2048, 2048, 112, True, 0, BF16),
    "seamless_encoder": (8, 16, 16, 512, 512, 64, False, 0, BF16),
    "seamless_cross": (8, 16, 16, 2048, 512, 64, False, 0, BF16),
    "seamless_decoder": (8, 16, 16, 2048, 2048, 64, True, 0, BF16),
    "internvl_prefill": (8, 64, 8, 2048, 2048, 128, True, 0, BF16),
    "qwen3_rank_prefill": (8, 8, 2, 2048, 2048, 128, True, 0, BF16),
    "deepseek_rank_prefill": (8, 32, 32, 1024, 1024, 192, True, 0, BF16),
}
FLASH_REHEARSAL = {
    "serving_prefill": (2, 4, 2, 40, 40, 16, True, 0, BF16),
    "arctic_prefill": (2, 7, 1, 24, 24, 16, True, 0, BF16),
    "gemma_prefill": (2, 4, 2, 40, 40, 320, True, 16, BF16),
    "d320_window": (1, 2, 1, 70, 70, 320, True, 24, BF16),
    "d256": (1, 2, 1, 70, 70, 256, True, 0, BF16),
    "suffix_tq1": (2, 4, 2, 1, 40, 16, True, 0, BF16),
    "noncausal_ragged": (1, 2, 2, 40, 40, 16, False, 0, BF16),
    "f32": (1, 4, 2, 37, 37, 16, True, 0, F32),
    "f32_d16": (1, 4, 2, 70, 70, 16, True, 0, F32),
    "f32_d320_window": (1, 2, 1, 70, 70, 320, True, 24, F32),
    "f32_serve_prefill": (4, 4, 4, 32, 32, 16, True, 0, F32),
    "f32_serve_prefill_window": (4, 4, 4, 32, 32, 16, True, 16, F32),
    "deepseek_prefill": (2, 4, 4, 24, 24, 24, True, 0, BF16),
    "deepseek_prefill_probs_bf16": (2, 4, 4, 24, 24, 24, True, 0, BF16),
    "f32_probs_bf16": (1, 4, 2, 37, 37, 16, True, 0, F32),
    "zamba2_prefill": (2, 4, 4, 40, 40, 112, True, 0, BF16),
    "seamless_encoder": (2, 4, 4, 10, 10, 16, False, 0, BF16),
    "seamless_cross": (2, 4, 4, 40, 10, 16, False, 0, BF16),
    "seamless_decoder": (2, 4, 4, 40, 40, 16, True, 0, BF16),
    "internvl_prefill": (2, 4, 4, 40, 40, 16, True, 0, BF16),
    "qwen3_rank_prefill": (2, 1, 1, 40, 40, 16, True, 0, BF16),
    "deepseek_rank_prefill": (2, 1, 1, 24, 24, 24, True, 0, BF16),
}
#: the frontend cells' and the multi-rank cells' flash calls (one rank's heads
#: of four), each timed beside scaled_dot_product_attention
FRONTEND_CASES = ("seamless_encoder", "seamless_cross", "seamless_decoder", "internvl_prefill",
                  "qwen3_rank_prefill")
#: cases' options: ``v_cols``, V's real columns (MLA pads V with zeros to
#: the qk head dim, as ``attention.mla_attention`` does: deepseek-v3's 128 of
#: 192, the reduced config's 16 of 24); ``probs_bf16``, the flag's instances;
#: ``instance_d``, the head dim of the instance the call must launch, its
#: operands read as they are (zamba2-7b's D=112, a multiple of 8: no padded copy)
FLASH_OPTIONS = {
    "deepseek_prefill": dict(v_cols=2 / 3),
    "deepseek_prefill_probs_bf16": dict(v_cols=2 / 3, probs_bf16=True),
    "deepseek_rank_prefill": dict(v_cols=2 / 3),
    "f32_probs_bf16": dict(probs_bf16=True),
    "zamba2_prefill": dict(instance_d=128),
}

# name -> (module, wrapper, plain, source, TPU kernel it replaces)
KERNELS = {
    "bin_offsets": (binning, "bin_offsets", "bin_offsets_plain",
                    "src/repro_torch/csrc/binning.cu", "src/repro/kernels/binning.py:72"),
    # the probes' CSR, and bin_offsets past one launch's bins: a stable
    # counting sort by digits of the bin
    "bin_csr": (binning, "bin_csr", "bin_csr_plain", "src/repro_torch/csrc/binning.cu",
                "src/repro/kernels/binning.py:72"),
    "pack_rows": (binning, "pack_rows", "pack_rows_plain",
                  "src/repro_torch/csrc/binning.cu", "src/repro/kernels/binning.py:229"),
    "place_rows": (binning, "place_rows", "place_rows_plain",
                   "src/repro_torch/csrc/binning.cu", "src/repro/kernels/binning.py:300"),
    "insert_arrivals": (hash_probe, "insert_arrivals", "insert_arrivals_plain",
                        "src/repro_torch/csrc/hash_probe.cu",
                        "src/repro/kernels/hash_probe.py:246"),
    "find_arrivals": (hash_probe, "find_arrivals", "find_arrivals_plain",
                      "src/repro_torch/csrc/hash_probe.cu",
                      "src/repro/kernels/hash_probe.py:406"),
    "insert": (hash_probe, "insert", "insert_plain", "src/repro_torch/csrc/hash_probe.cu",
               "src/repro/kernels/hash_probe.py:134"),
    "find": (hash_probe, "find", "find_plain", "src/repro_torch/csrc/hash_probe.cu",
             "src/repro/kernels/hash_probe.py:328"),
    "membership": (bloom_kernel, "membership", "membership_plain",
                   "src/repro_torch/csrc/bloom.cu", "src/repro/kernels/bloom_kernel.py:88"),
    "hash_words": (bloom_kernel, "hash_words", "hash_words_plain",
                   "src/repro_torch/csrc/bloom.cu", "src/repro/kernels/bloom_kernel.py:62"),
    "row_mix": (binning, "row_mix", "row_mix_plain", "src/repro_torch/csrc/binning.cu",
                "src/repro/kernels/binning.py:349"),
    "ragged_slots": (binning, "ragged_slots", "ragged_slots_plain",
                     "src/repro_torch/csrc/binning.cu", "src/repro/kernels/binning.py:139"),
    "histogram": (binning, "histogram", "histogram_plain", "src/repro_torch/csrc/binning.cu",
                  "src/repro/kernels/binning.py:368"),
    # one TPU kernel, two routes by dtype: bf16 by wgmma, float32 by 3xTF32 mma.sync
    "flash_attention": (fa, "flash_attention", "flash_attention_plain",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
    "flash_attention_f32": (fa, "flash_attention", "flash_attention_plain",
                            "src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:82"),
    # no TPU kernel: the recurrent mixers' lax.scan bodies, one launch a layer and call
    # Mamba2's, two routes by shape: the chunked SSD form, the sequential kernel
    "mamba_scan": (ssm_scan, "mamba_scan", "mamba_scan_plain", "src/repro_torch/csrc/ssm_scan.cu",
                   "src/repro/models/ssm.py:98"),
    "mamba_scan_seq": (ssm_scan, "mamba_scan", "mamba_scan_plain",
                       "src/repro_torch/csrc/ssm_scan.cu", "src/repro/models/ssm.py:98"),
    "rwkv_scan": (ssm_scan, "rwkv_scan", "rwkv_scan_plain", "src/repro_torch/csrc/ssm_scan.cu",
                  "src/repro/models/ssm.py:183"),
}
#: the kernels each path runs
HASHMAP_KERNELS = ("bin_offsets", "bin_csr", "pack_rows", "place_rows", "insert_arrivals",
                   "find_arrivals")
GENOMICS_KERNELS = HASHMAP_KERNELS + ("insert", "find", "membership", "hash_words")
EXT_KERNELS = HASHMAP_KERNELS + ("row_mix",)
DEDUP_KERNELS = HASHMAP_KERNELS + ("hash_words", "membership")
#: the exchange wire's binning and pack (the wire split's kernels)
WIRE_KERNELS = ("bin_offsets", "pack_rows")
#: kernels no path reaches (the kernel phase derives their inputs)
OFF_PATH = ("ragged_slots", "histogram")
#: the recurrent mixers' scans (held on the recurrent cells' own calls)
SCAN_KERNELS = ("mamba_scan", "mamba_scan_seq", "rwkv_scan")
#: the float kernels: held at a tolerance on the cases above, the float32 serve
#: phase's own calls and the scans' calls, not on the container paths' captured calls
FLOAT_KERNELS = ("flash_attention", "flash_attention_f32", *SCAN_KERNELS)
#: the flash_attention case each float kernel's JSON row reports
FLASH_ROWS = {"flash_attention": "serving_prefill", "flash_attention_f32": "f32"}
#: the flash_attention cases timed beside scaled_dot_product_attention
SDPA_CASES = (*FLASH_ROWS.values(), "arctic_prefill", "gemma_prefill", *FLASH_OPTIONS,
              *FRONTEND_CASES)
#: a kernels-line row's keys that stay in the phase's own printed lines
ROW_DETAIL = ("shape", "tol", "sdpa_ratio", "regime", "cuda_core_ms", "device_ms", "rel_l2",
              "state_equal", "host_us")


@contextlib.contextmanager
def planted(plant):
    """``plant`` = (owner, function name, wrapper): the wrapped function in
    place while the block runs (None: nothing planted)."""
    if plant is None:
        yield
        return
    owner, name, wrap = plant
    real = getattr(owner, name)
    setattr(owner, name, wrap(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# data: distinct u32 keys as fmix32 of disjoint counter ranges (a bijection)
# --------------------------------------------------------------------------

def keys_at(start: int, n: int, dev) -> torch.Tensor:
    ctr = to_i32(torch.arange(start, start + n, dtype=torch.int64, device=dev))
    return fmix32(ctr)


def value_of(keys: torch.Tensor) -> torch.Tensor:
    return to_i32(as_u64(keys) * 3 + 1)


def workload(sz: dict, dev, seed: int) -> dict:
    """Keys of every phase, from the seed; int32 words."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    wave, n_in = sz["wave"], sz["wave"] * sz["waves"]
    waves = [keys_at(w * wave, wave, dev) for w in range(sz["waves"])]
    # ~1% in-wave duplicates in wave 1: copies of earlier keys of the wave
    ndup = wave // 100
    pos = torch.randperm(wave - wave // 2, generator=gen)[:ndup] + wave // 2
    src = torch.randint(0, wave // 2, (ndup,), generator=gen)
    waves[1][pos.to(dev)] = waves[1][src.to(dev)]
    inserted = torch.unique(torch.cat(waves))
    absent0 = 1 << 31                        # counters no insert uses
    half, fhalf = sz["find"] // 2, sz["fi"] // 2
    pick = torch.randperm(inserted.numel(), generator=gen)[:half + fhalf].to(dev)
    return dict(
        waves=waves, n_distinct=int(inserted.numel()), n_in=n_in,
        find=torch.cat([inserted[pick[:half]], keys_at(absent0, half, dev)]),
        fi_find=torch.cat([inserted[pick[half:]], keys_at(absent0 + half, fhalf, dev)]),
        fi_ins=keys_at(n_in, sz["fi"], dev))


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def u32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint32)


def main_path(impl: str, sz: dict, data: dict, dev) -> dict:
    """The port's hash-map entry points at full width; results + timings."""
    bk = SerialBackend()
    spec, st = hm.hashmap_create(bk, sz["capacity"], Spec((), torch.uint32),
                                 Spec((), torch.uint32), block_size=sz["block"],
                                 impl=impl, device=dev)
    out = {"insert_s": [], "ok": []}
    sync(dev)
    for keys in data["waves"]:
        t0 = time.perf_counter()
        st, ok = hm.insert(bk, spec, st, u32(keys), u32(value_of(keys)),
                           capacity=keys.numel())
        sync(dev)
        out["insert_s"].append(time.perf_counter() - t0)
        out["ok"].append(ok)
    q = data["find"]
    t0 = time.perf_counter()
    st, vals, found = hm.find(bk, spec, st, u32(q), capacity=q.numel())
    sync(dev)
    out["find_s"] = time.perf_counter() - t0
    fk, ik = data["fi_find"], data["fi_ins"]
    t0 = time.perf_counter()
    st, fvals, ffound, fok = hm.find_insert(bk, spec, st, u32(fk), u32(ik),
                                            u32(value_of(ik)), capacity=ik.numel())
    sync(dev)
    out["find_insert_s"] = time.perf_counter() - t0
    out.update(state=st, vals=vals.view(torch.int32), found=found,
               fvals=fvals.view(torch.int32), ffound=ffound, fok=fok,
               count=int(hm.count_ready(bk, st)))
    return out


def check_oracle(r: dict, data: dict, sz: dict) -> None:
    """Every present key found with 3k+1, no absent key found, counts exact."""
    for w, ok in enumerate(r["ok"]):
        check(bool(ok.all()), f"insert wave {w}: every key lands")
    half, fhalf = sz["find"] // 2, sz["fi"] // 2
    check(bool(r["found"][:half].all()), "find: every present key found")
    check(not bool(r["found"][half:].any()), "find: no absent key found")
    check(torch.equal(r["vals"][:half], value_of(data["find"][:half])),
          "find: values are 3k+1")
    check(bool(r["ffound"][:fhalf].all()) and not bool(r["ffound"][fhalf:].any()),
          "find_insert: present found, absent not")
    check(torch.equal(r["fvals"][:fhalf], value_of(data["fi_find"][:fhalf])),
          "find_insert: values are 3k+1")
    want = data["n_distinct"] + int(r["fok"].sum())
    check(r["count"] == want, f"count_ready {r['count']} == distinct inserted {want}")


def same_results(a: dict, b: dict) -> None:
    for name in ("tkeys", "tvals", "status"):
        check(torch.equal(getattr(a["state"], name), getattr(b["state"], name)),
              f"kernel and plain runs: table {name} bit-identical")
    for name in ("found", "vals", "ffound", "fvals", "fok"):
        check(torch.equal(a[name], b[name]), f"kernel and plain runs: {name} identical")
    for w, (x, y) in enumerate(zip(a["ok"], b["ok"])):
        check(torch.equal(x, y), f"kernel and plain runs: wave {w} successes identical")


# --------------------------------------------------------------------------
# the genomics path: k-mer counting and de Bruijn build + walk
# --------------------------------------------------------------------------

KSPEC, VSPEC = Spec((2,), torch.uint32), Spec((), torch.uint32)


def _absent_kmers(n: int, gen_: torch.Generator, dev) -> torch.Tensor:
    """(n, 2) words no 21-mer can be: hi above the 10 bits a 21-mer uses."""
    hi = torch.randint(1 << 10, 1 << 30, (n,), generator=gen_)
    lo = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen_)
    return torch.stack([hi, lo], dim=1).to(torch.int32).to(dev)


def genomics_workload(gz: dict, dev, seed: int) -> dict:
    """Reads from the seed (numpy, as the JAX package makes them), packed
    into k-mers on the card, and the oracle's facts, computed on the
    card independently of the containers."""
    k = gz["k"]
    sim = gen.GenomeSim(genome_len=gz["genome_len"], read_len=100, coverage=8,
                        error_rate=0.01, seed=seed)
    reads = torch.from_numpy(sim.reads()).to(dev)
    kmers = gen.read_kmer_lanes(reads, k)
    uniq, cnt = torch.unique(gen.kmer_values(kmers), return_counts=True)
    # solid extensions: (k+1)-mers seen at least twice; keep the k-mers
    # with exactly one solid extension (Meraculous' unique-extension rule)
    ext, ecnt = torch.unique(gen.kmer_values(gen.read_kmer_lanes(reads, k + 1)),
                             return_counts=True)
    ext = ext[ecnt >= 2]
    key = ext >> 2                                   # sorted, as ext is
    _, per_key = torch.unique_consecutive(key, return_counts=True)
    single = torch.repeat_interleave(per_key == 1, per_key)
    ext_key, ext_next = gen.kmer_lanes(key[single]), (ext[single] & 3).to(torch.int32)
    n, n_ext = kmers.shape[0], ext_key.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    half = gz["probes"] // 2
    pick = torch.randint(0, n, (half,), generator=g).to(dev)
    starts = torch.randint(0, n_ext, (gz["walks"],), generator=g).to(dev)
    return dict(
        kmers=kmers, n=n, uniq=uniq, cnt=cnt, ext_key=ext_key, ext_next=ext_next,
        n_ext=n_ext, probes=torch.cat([kmers[pick], _absent_kmers(half, g, dev)]),
        lookup=torch.cat([ext_key, _absent_kmers(n_ext, g, dev)]),
        starts=ext_key[starts])


def genomics_path(impl: str, gz: dict, g: dict, dev, steps=None) -> dict:
    """The port's containers along the paper's assembly pipeline."""
    bk = SerialBackend()
    n, n_ext = g["n"], g["n_ext"]
    t = {}

    def lap(name, t0):
        sync(dev)
        t[name] = time.perf_counter() - t0
        return time.perf_counter()

    def table():
        return hm.hashmap_create(bk, gz["table"], KSPEC, VSPEC, block_size=gz["block"],
                                 impl=impl, device=dev)

    sync(dev)
    t0 = time.perf_counter()
    bspec, bst = bl.bloom_create(bk, gz["bloom_bits"], KSPEC, k=gz["bloom_k"],
                                 impl=impl, device=dev)
    bst, seen = bl.insert(bk, bspec, bst, g["kmers"], capacity=n)
    t0 = lap("bloom_insert_s", t0)
    present = bl.find(bk, bspec, bst, g["probes"], capacity=g["probes"].shape[0])
    t0 = lap("bloom_find_s", t0)

    cspec, cst = table()
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    cst, cok = hm.insert(bk, cspec, cst, g["kmers"], ones, capacity=n, mode=MODE_ADD,
                         attempts=2, valid=seen)
    t0 = lap("count_s", t0)

    dspec, dst = table()
    dst, dok = hm.insert(bk, dspec, dst, g["ext_key"], g["ext_next"], capacity=n_ext,
                         attempts=2)
    t0 = lap("build_direct_s", t0)

    mspec, mst = table()
    hspec, hst = hb.create(bk, mspec, mst, queue_capacity=2 * n_ext,
                           buffer_cap=2 * n_ext)
    hst, over = hb.insert(hspec, hst, g["ext_key"], g["ext_next"])
    hst, dropped = hb.flush(bk, hspec, hst, capacity=2 * n_ext)
    t0 = lap("build_buffered_s", t0)

    _, lvals, lfound = hm.find(bk, mspec, hst.map, g["lookup"], capacity=1,
                               promise=ConProm.HashMap.local)
    t0 = lap("lookup_s", t0)

    cur, walked = g["starts"], torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(gz["steps"] if steps is None else steps):
        _, v, f = hm.find(bk, mspec, hst.map, cur, capacity=cur.shape[0],
                          promise=ConProm.HashMap.find, attempts=2)
        cur = torch.where(f[:, None], gen.kmer_step(cur, v.view(torch.int32), gz["k"]),
                          cur)
        walked += f.sum()
    lap("walk_s", t0)

    return dict(times=t, bloom=bst.words, seen=seen, present=present, count=cst,
                cok=cok, direct=dst, dok=dok, buffered=hst.map, over=int(over),
                dropped=int(dropped), lvals=lvals.view(torch.int32), lfound=lfound,
                walked=int(walked), count_ready=int(hm.count_ready(bk, hst.map)),
                direct_ready=int(hm.count_ready(bk, dst)),
                fill=float(bl.fill_fraction(bk, bst)))


def check_genomics(r: dict, g: dict, gz: dict) -> None:
    """Counts within [c-1, c] for every k-mer seen c >= 2 times (a Bloom
    false positive can add one, nothing can take one away); every present
    probe found; both builds hold exactly the extensions; the local find
    returns each extension's next base and no absent key."""
    half = gz["probes"] // 2
    check(bool(r["present"][:half].all()), "bloom.find: every inserted k-mer found")
    occ = (r["count"].status.reshape(-1) & 3) == 2
    tkey = gen.kmer_values(r["count"].tkeys.reshape(-1, 2)[occ])
    tval = r["count"].tvals.reshape(-1)[occ].to(torch.int64)
    pos = torch.searchsorted(g["uniq"], tkey).clamp(max=g["uniq"].numel() - 1)
    check(bool((g["uniq"][pos] == tkey).all()), "count table: every key is a k-mer")
    check(torch.unique(tkey).numel() == tkey.numel(), "count table: keys distinct")
    tcount = torch.zeros_like(g["cnt"])
    tcount[pos] = tval
    held = torch.zeros_like(g["cnt"], dtype=torch.bool)
    held[pos] = True
    need = g["cnt"] >= 2
    check(bool(held[need].all()), "count table: every k-mer seen twice is counted")
    c = g["cnt"][need]
    check(bool(((tcount[need] >= c - 1) & (tcount[need] <= c)).all()),
          "count table: counts within [c-1, c]")
    check(bool(r["cok"][r["seen"]].all()), "count insert: every seen k-mer landed")
    check(bool(r["dok"].all()) and r["direct_ready"] == g["n_ext"],
          f"direct build: {r['direct_ready']} entries == {g['n_ext']} extensions")
    check(r["dropped"] == 0 and r["over"] == 0 and r["count_ready"] == g["n_ext"],
          f"buffered build: dropped {r['dropped']}, count_ready {r['count_ready']} "
          f"== {g['n_ext']}")
    ne = g["n_ext"]
    check(bool(r["lfound"][:ne].all()) and not bool(r["lfound"][ne:].any()),
          "local find: every extension found, no absent key")
    check(torch.equal(r["lvals"][:ne], g["ext_next"]),
          "local find: each extension's next base")
    check(r["walked"] > 0, "walk: the walks advanced")


def same_genomics(a: dict, b: dict) -> None:
    for name in ("bloom", "seen", "present", "cok", "dok", "lvals", "lfound"):
        check(torch.equal(a[name], b[name]), f"kernel and plain runs: {name} identical")
    for table in ("count", "direct", "buffered"):
        for f in ("tkeys", "tvals", "status"):
            check(torch.equal(getattr(a[table], f), getattr(b[table], f)),
                  f"kernel and plain runs: {table} table {f} bit-identical")
    for name in ("over", "dropped", "walked", "count_ready", "direct_ready", "fill"):
        check(a[name] == b[name], f"kernel and plain runs: {name} {a[name]} == {b[name]}")


# --------------------------------------------------------------------------
# the extensions path: integrity, faults, degraded commits, hier, split phase
# --------------------------------------------------------------------------

U32 = Spec((), torch.uint32)


def ext_workload(xz: dict, dev, seed: int) -> dict:
    """Keys of a fresh counter range (the other paths use none of it)."""
    gen_ = torch.Generator(device="cpu").manual_seed(seed + 2)
    n, fi = xz["n"], xz["fi"]
    base = 1 << 30
    keys = keys_at(base, n, dev)
    pick = torch.randperm(n, generator=gen_)[:n // 2 + fi // 2].to(dev)
    return dict(
        keys=keys, find=torch.cat([keys[pick[:n // 2]], keys_at(base + n, n // 2, dev)]),
        fi_find=torch.cat([keys[pick[n // 2:]], keys_at(base + 2 * n, fi // 2, dev)]),
        fi_ins=keys_at(base + 3 * n, fi, dev))


def _waves(t: torch.Tensor, wave: int):
    return [t[i:i + wave] for i in range(0, t.shape[0], wave)]


def _tensors(res: dict):
    """The tensors of a phase's result, tables unpacked."""
    for v in res.values():
        yield from (v if isinstance(v, tuple) else (v,))


def _table_keys(st) -> torch.Tensor:
    """The keys a table holds, sorted (read straight off its arrays)."""
    occ = (st.status.reshape(-1) & 3) == 2
    return torch.sort(st.tkeys.reshape(-1)[occ]).values


def ext_path(impl: str, xz: dict, xd: dict, dev, phases=(1, 2, 3, 4, 5)) -> dict:
    """The exchange extensions through the hash map's entry points."""
    bk = SerialBackend()
    n, cap, rounds, wave = xz["n"], xz["cap"], xz["rounds"], xz["wave"]
    keys = xd["keys"]
    vals = value_of(keys)
    t, out = {}, {}

    def table():
        return hm.hashmap_create(bk, xz["capacity"], U32, U32, block_size=xz["block"],
                                 impl=impl, device=dev)

    def lap(name, t0):
        sync(dev)
        t[name] = time.perf_counter() - t0
        return time.perf_counter()

    spec, st = table()
    sync(dev)
    t0 = time.perf_counter()
    if 1 in phases:
        # 1. a corrupted round-0 window under integrity checks: a fresh
        # fault transport, so its launch numbering starts at 0
        faulty = FaultInjectingTransport(DENSE, FaultSpec(seed=7, corrupt=((0, 0, 0),)))
        st, ok1 = hm.insert(bk, spec, st, u32(keys), u32(vals), capacity=cap,
                            max_rounds=rounds, attempts=1, integrity=True,
                            transport=faulty)
        t0 = lap("corrupt_insert_s", t0)
        out.update(ok1=ok1, launches_faulty=faulty.launches, table1=st)
    if 2 in phases:
        # 2. heal: re-send exactly the unacked inserts over the clean wire
        st, ok2 = hm.insert(bk, spec, st, u32(keys), u32(vals), capacity=cap,
                            max_rounds=rounds, attempts=1, integrity=True,
                            valid=~out["ok1"])
        t0 = lap("heal_s", t0)
        _, hvals, hfound = hm.find(bk, spec, st, u32(keys), capacity=n)
        t0 = lap("heal_find_s", t0)
        out.update(ok2=ok2, hvals=hvals.view(torch.int32), hfound=hfound, table2=st)
    if 3 in phases:
        # 3. degraded probe: the only rank declared dead at admission
        with costs.recording() as log:
            st3, ok3 = hm.insert(bk, spec, st, u32(keys[:8]), u32(vals[:8]), capacity=8,
                                 attempts=1, dead_ranks=(0,))
        t0 = lap("degraded_s", t0)
        out.update(ok3=ok3, unreachable=log.total().unreachable,
                   degraded_same=all(torch.equal(a, b) for a, b in zip(st, st3)))
    del st                       # every table below shares ``spec``

    def turn(name, t0):
        # phases 4 and 5 run each variant twice, in turns (A, B, B, A):
        # the time kept is the mean of the two runs
        sync(dev)
        t[name] = t.get(name, 0.0) + (time.perf_counter() - t0) / 2
        return time.perf_counter()

    def keep(label, res):
        # the repeated run of a variant must give the same bits
        if label in out:
            check(all(torch.equal(x, y) for x, y in zip(_tensors(out[label]),
                                                         _tensors(res))),
                  f"{label}: the repeated run is bit-identical")
        else:
            out[label] = res

    if 4 in phases:
        # 4. the same inserts and a speculative find over both transports
        for tr in ("dense", "hier", "hier", "dense"):
            _, st_t = table()
            sync(dev)
            t0 = time.perf_counter()
            oks = []
            for k, v in zip(_waves(keys, wave), _waves(vals, wave)):
                st_t, ok = hm.insert(bk, spec, st_t, u32(k), u32(v), capacity=wave,
                                     transport=tr)
                oks.append(ok)
            t0 = turn(f"{tr}_insert_s", t0)
            fv, ff = [], []
            for q in _waves(xd["find"], wave):
                st_t, v, f = hm.find(bk, spec, st_t, u32(q), capacity=wave, transport=tr)
                fv.append(v.view(torch.int32))
                ff.append(f)
            turn(f"{tr}_find_s", t0)
            keep(tr, dict(table=st_t, ok=torch.cat(oks), vals=torch.cat(fv),
                          found=torch.cat(ff)))
    if 5 in phases:
        # 5. split-phase find_insert over the hier transport vs the sync one,
        # each on a copy of the hier table
        for mode in ("async", "sync", "sync", "async"):
            st_m = hm.HashMapState(*(x.clone() for x in out["hier"]["table"]))
            waves = zip(_waves(xd["fi_find"], wave), _waves(xd["fi_ins"], wave))
            sync(dev)
            t0 = time.perf_counter()
            res = []
            for fk, ik in waves:
                args = (bk, spec, st_m, u32(fk), u32(ik), u32(value_of(ik)))
                if mode == "async":
                    r = hm.find_insert(*args, capacity=wave, transport="hier",
                                       async_=True).finish()
                else:
                    r = hm.find_insert(*args, capacity=wave, transport="hier")
                st_m = r[0]
                res.append(r[1:])
            turn(f"{mode}_find_insert_s", t0)
            keep(mode, dict(table=st_m, vals=torch.cat([r[0] for r in res]).view(torch.int32),
                            found=torch.cat([r[1] for r in res]),
                            ok=torch.cat([r[2] for r in res])))
    out["times"] = t
    return out


def check_ext(r: dict, xd: dict, xz: dict) -> None:
    """The extensions oracle, computed on the card from the keys alone."""
    n, cap = xz["n"], xz["cap"]
    keys = xd["keys"]
    ok1 = r["ok1"]
    check(int((~ok1).sum()) == cap, f"corrupted wire: {int((~ok1).sum())} unacked == {cap}")
    check(not bool(ok1[:cap].any()) and bool(ok1[cap:].all()),
          "corrupted wire: exactly the round-0 window (bucket ranks < cap) failed")
    check(torch.equal(_table_keys(r["table1"]), torch.sort(keys[cap:]).values),
          "corrupted wire: the table holds every acked key and no failed one")
    check(bool(r["ok2"][~ok1].all()) and int((~ok1 & ~r["ok2"]).sum()) == 0,
          "heal: every re-sent insert acks, lost == 0")
    check(bool(r["hfound"].all()) and torch.equal(r["hvals"], value_of(keys)),
          "heal: a find of every key returns 3k+1")
    check(not bool(r["ok3"].any()) and r["degraded_same"] and r["unreachable"] == 1,
          f"degraded probe: no ack, table unchanged, unreachable {r['unreachable']} == 1")
    d, h = r["dense"], r["hier"]
    for f in ("tkeys", "tvals", "status"):
        check(torch.equal(getattr(d["table"], f), getattr(h["table"], f)),
              f"hier vs dense: table {f} bit-identical")
    for f in ("ok", "vals", "found"):
        check(torch.equal(d[f], h[f]), f"hier vs dense: {f} identical")
    half = n // 2
    check(bool(h["ok"].all()) and bool(h["found"][:half].all())
          and not bool(h["found"][half:].any())
          and torch.equal(h["vals"][:half], value_of(xd["find"][:half])),
          "hier: every key lands, present keys found with 3k+1, absent not")
    a, s = r["async"], r["sync"]
    for f in ("tkeys", "tvals", "status"):
        check(torch.equal(getattr(a["table"], f), getattr(s["table"], f)),
              f"split phase vs sync: table {f} bit-identical")
    for f in ("vals", "found", "ok"):
        check(torch.equal(a[f], s[f]), f"split phase vs sync: {f} identical")
    fhalf = xz["fi"] // 2
    check(bool(a["ok"].all()) and bool(a["found"][:fhalf].all())
          and not bool(a["found"][fhalf:].any())
          and torch.equal(a["vals"][:fhalf], value_of(xd["fi_find"][:fhalf])),
          "split phase: inserts land, present found with 3k+1, absent not")


def same_ext(a: dict, b: dict) -> None:
    for name in ("ok1", "ok2", "hvals", "hfound", "ok3"):
        check(torch.equal(a[name], b[name]), f"kernel and plain runs: {name} identical")
    tables = [("table1", a["table1"], b["table1"]), ("table2", a["table2"], b["table2"])]
    tables += [(m, a[m]["table"], b[m]["table"]) for m in ("dense", "hier", "async")]
    for label, x, y in tables:
        for f in ("tkeys", "tvals", "status"):
            check(torch.equal(getattr(x, f), getattr(y, f)),
                  f"kernel and plain runs: {label} {f} bit-identical")
    for m in ("hier", "async"):
        for f in ("vals", "found", "ok"):
            check(torch.equal(a[m][f], b[m][f]), f"kernel and plain runs: {m} {f} identical")
    check(a["unreachable"] == b["unreachable"] and a["launches_faulty"] == b["launches_faulty"],
          "kernel and plain runs: the same launches and unreachable count")


# --------------------------------------------------------------------------
# the dedup path: LM-data dedup (data/dedup.py) over the port's token stream
# --------------------------------------------------------------------------

def dedup_corpus(dz: dict, seed: int) -> dict:
    """The corpus, made once on the host from the port's TokenStream
    (qwen3-4b's tokenizer width; rows cut to ``seq_len`` tokens): the
    observe batches, from the second on with 1/8 of their rows verbatim
    copies of earlier rows and 1/8 an earlier row's first half with a
    fresh second half; a fresh batch for observe_and_probe; a probe of
    half held-out, half observed documents; the planted copies for
    count_of."""
    stream = TokenStream(dz["vocab"], dz["seq_len"], dz["docs"] // 8, seed=seed)
    rng = np.random.default_rng(seed + 7)
    d, t, k = dz["docs"], dz["seq_len"], dz["docs"] // 8

    def fresh(n: int) -> np.ndarray:
        return np.concatenate([stream.next_batch(device="cpu")["tokens"][:, :t].numpy()
                               for _ in range(n // k)])
    corpus = np.empty((dz["batches"] * d, t), np.int32)
    corpus[:d] = fresh(d)
    copies = []
    for i in range(1, dz["batches"]):
        rows = i * d + rng.permutation(d)
        verbatim, half = rows[:k], rows[k:2 * k]
        corpus[rows[2 * k:]] = fresh(d - 2 * k)
        corpus[verbatim] = corpus[rng.integers(0, i * d, k)]
        corpus[half] = fresh(k)
        corpus[half, :t // 2] = corpus[rng.integers(0, i * d, k), :t // 2]
        copies.append(np.sort(verbatim))
    copies = np.concatenate(copies)
    probe = np.concatenate([fresh(dz["probe"] // 2),
                            corpus[rng.integers(0, len(corpus), dz["probe"] // 2)]])
    return dict(batches=[corpus[i * d:(i + 1) * d] for i in range(dz["batches"])],
                fresh=fresh(d), probe=probe, copies=copies,
                planted=corpus[copies[rng.permutation(len(copies))[:dz["planted"]]]])


def shingle_hashes(tokens: np.ndarray, n: int) -> np.ndarray:
    """The oracle's own shingling, as the JAX package computes it: the
    rolling hash in numpy uint64, (B, T-n+1) values in row order."""
    b, t = tokens.shape
    h = np.zeros((b, t - n + 1), np.uint64)
    for i in range(n):
        h = h * np.uint64(1099511628211) ^ tokens[:, i:t - n + 1 + i].astype(np.uint64)
    return h


def dedup_oracle(dz: dict, corpus: dict, dev) -> dict:
    """The exact facts of the stream, independent of the containers: every
    ingested shingle (the observe batches, then the observe_and_probe
    batch, in stream order: at P=1 with stable binning the order they
    reach the filter), whether the same shingle occurred earlier, each
    value's sightings, and which probe shingles occurred at all."""
    n = dz["ngram"]
    ingest = corpus["batches"] + [corpus["fresh"]]
    h = torch.from_numpy(np.concatenate([shingle_hashes(b, n).reshape(-1) for b in ingest])
                         .view(np.int64)).to(dev)
    vals, order = torch.sort(h, stable=True)
    first = torch.ones_like(vals, dtype=torch.bool)
    first[1:] = vals[1:] != vals[:-1]
    earlier = torch.empty_like(first)
    earlier[order] = ~first
    uniq, count = torch.unique_consecutive(vals, return_counts=True)

    def lookup(tokens):
        q = torch.from_numpy(shingle_hashes(tokens, n).reshape(-1).view(np.int64)).to(dev)
        pos = torch.searchsorted(uniq, q).clamp(max=uniq.numel() - 1)
        return q, pos, uniq[pos] == q
    probe_q, _, probe_occurred = lookup(corpus["probe"])
    planted_q, planted_pos, planted_hit = lookup(corpus["planted"])
    return dict(h=h, order=order, first=first, earlier=earlier, uniq=uniq, count=count,
                probe_occurred=probe_occurred, planted_pos=planted_pos,
                planted_hit=planted_hit, shingles=h.numel())


def _tap_dedup(record: dict):
    """Wrap the container calls a Deduper makes so a run keeps each
    ingest's ``seen`` flags, the probe's flags and each counting insert's
    successes (device tensors, no host sync); returns the undo list."""
    real = [(bl, "insert", bl.insert), (bl, "insert_find", bl.insert_find),
            (hm, "insert", hm.insert)]

    def b_insert(*a, **kw):
        out = real[0][2](*a, **kw)
        record["seen"].append(out[1])
        return out

    def b_insert_find(*a, **kw):
        out = real[1][2](*a, **kw)
        record["seen"].append(out[1])
        record["probed"].append(out[2])
        return out

    def h_insert(*a, **kw):
        out = real[2][2](*a, **kw)
        record["ok"].append(out[1])
        return out
    bl.insert, bl.insert_find, hm.insert = b_insert, b_insert_find, h_insert
    return real


def dedup_path(impl: str, dz: dict, dd: dict, dev) -> dict:
    """The port's Deduper through its entry points: every observe batch,
    one observe_and_probe, one count_of; verdicts, state, the cost log,
    the tapped flags and the host-clock seconds of each call."""
    spec = DedupSpec(ngram=dz["ngram"], nbits=dz["nbits"], table_capacity=dz["table"],
                     dup_threshold=dz["threshold"], max_rounds=dz["rounds"])
    tap = {"seen": [], "probed": [], "ok": []}
    out = {"observe": [], "observe_s": [], "model_rates": [0.0]}
    undo = _tap_dedup(tap)
    try:
        dedup = Deduper(SerialBackend(), spec, device=dev, impl=impl)
        with costs.recording() as log:
            sync(dev)
            for b in dd["batches"]:
                t0 = time.perf_counter()
                out["observe"].append(dedup.observe(b))
                sync(dev)
                out["observe_s"].append(time.perf_counter() - t0)
                out["model_rates"].append(ap_bloom_rate(dedup.bstate.words, dedup.bspec.k, dz["sample"]))
            t0 = time.perf_counter()
            out["oap"] = dedup.observe_and_probe(dd["fresh"], dd["probe"])
            sync(dev)
            out["oap_s"] = time.perf_counter() - t0
            out["model_rates"].append(ap_bloom_rate(dedup.bstate.words, dedup.bspec.k, dz["sample"]))
            t0 = time.perf_counter()
            out["counts"] = dedup.count_of(dd["planted"])
            sync(dev)
            out["count_s"] = time.perf_counter() - t0
    finally:
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)
    out.update(dedup=dedup, costs={op: log.by_op(op).__dict__
                                   for op in sorted({n for n, _ in log.entries})},
               seen=torch.cat(tap["seen"]), probed=torch.cat(tap["probed"]),
               ok=torch.cat(tap["ok"]),
               fill=float(bl.fill_fraction(dedup.backend, dedup.bstate)),
               occupancy=int(hm.count_ready(dedup.backend, dedup.hstate)) / dz["table"])
    return out


def ap_bloom_rate(words: torch.Tensor, k: int, sample: int) -> float:
    """The false-positive rate a fresh item meets in the filter ``words``,
    from a model of the blocked scheme written from its definition, not
    from the program's hashing: an item's block is uniform, and its k bits
    are b, b + s, ..., b + (k-1)s mod 64 for b uniform in [0, 64) and s
    uniform odd (double hashing with an odd step).  The rate is the mean,
    over ``sample`` blocks drawn uniformly (seeded), of the share of the
    64 x 32 (b, s) pairs whose bits the block holds all of."""
    masks = []
    for b in range(64):
        for step in range(1, 64, 2):
            m = sum(1 << ((b + i * step) % 64) for i in range(k))
            masks.append(m - (1 << 64) if m >= 1 << 63 else m)     # as int64
    masks = torch.tensor(masks, dtype=torch.int64, device=words.device)
    g = torch.Generator(device=words.device).manual_seed(len(masks))
    pick = torch.randint(0, words.shape[0], (sample,), generator=g, device=words.device)
    w = words[pick].to(torch.int64)
    blocks = (w[:, 1] << 32) | (w[:, 0] & 0xFFFFFFFF)
    held = 0
    for c in range(0, sample, 1 << 12):
        blk = blocks[c:c + (1 << 12), None]
        held += int(((blk & masks) == masks).sum())
    return held / (sample * len(masks))


def check_dedup(r: dict, dz: dict, dd: dict, oracle: dict) -> None:
    """The exact oracle: no ingested shingle that occurred earlier in the
    stream goes unseen; the excess (new shingles read seen) stays within
    twice the rate the scheme's model (:func:`ap_bloom_rate`) gives for
    the fill the ingest saw, each batch's new shingles at the mean of the
    model's rates before and after that batch; verbatim copies rate 1.0
    and are flagged; the probe's observed half reads 1.0 and its held-out
    half sees only shingles that occurred, up to twice the model's rate
    for the final filter; and count_of equals 1 + the landed insertions
    of each shingle exactly, which is its sightings except where an
    excess or a failed insert explains the gap."""
    seen, earlier = r["seen"], oracle["earlier"]
    check(seen.shape == earlier.shape, f"dedup: {seen.numel()} seen flags for "
                                       f"{earlier.numel()} ingested shingles")
    missed = int((earlier & ~seen).sum())
    check(missed == 0, f"dedup: {missed} shingles seen earlier in the stream read unseen")
    excess = seen & ~earlier
    new = int((~earlier).sum())
    rate = int(excess.sum()) / max(1, new)
    # each ingest batch's new shingles at the mean of the model's rates
    # before and after it (the observe batches, then observe_and_probe's)
    mr = r["model_rates"]
    per = earlier.numel() // (len(mr) - 1)
    check(per * (len(mr) - 1) == earlier.numel(), "dedup: equal ingest batches")
    want = sum(int((~earlier[i * per:(i + 1) * per]).sum()) * (mr[i] + mr[i + 1]) / 2
               for i in range(len(mr) - 1))
    predicted = want / max(1, new)
    r["excess_rate"], r["predicted_rate"], r["final_model_rate"] = rate, predicted, mr[-1]
    print(f"dedup: excess rate {rate} against the model's {predicted} for the ingest's "
          f"fill (ratio {rate / predicted if predicted else float('nan')}); the model's rate "
          f"after each batch {mr[1:]}", flush=True)
    check(rate <= 2 * predicted, f"dedup: excess rate {rate} within twice the model's "
                                 f"{predicted} for the fill the ingest saw")
    frac = torch.cat([f for f, _ in r["observe"]])
    dup = torch.cat([x for _, x in r["observe"]])
    copies = torch.from_numpy(dd["copies"]).to(frac.device)
    check(bool((frac[copies] == 1.0).all()) and bool(dup[copies].all()),
          "dedup: every verbatim copy has dup_frac 1.0 and is flagged")
    n_sh = dz["seq_len"] - dz["ngram"] + 1
    pf = r["oap"][2]
    half = dz["probe"] // 2
    check(bool((pf[half:] == 1.0).all()), "dedup: the probe's observed half reads 1.0")
    probed, occurred = r["probed"], oracle["probe_occurred"]
    check(not bool((occurred & ~probed).any()), "dedup: every probe shingle that occurred "
                                                "reads seen")
    held = probed[:half * n_sh] & ~occurred[:half * n_sh]
    held_rate = int(held.sum()) / max(1, int((~occurred[:half * n_sh]).sum()))
    r["probe_excess_rate"] = held_rate
    check(held_rate <= 2 * mr[-1], f"dedup: the held-out probe's excess rate {held_rate} "
                                   f"within twice the model's {mr[-1]} for the final filter")
    # count_of: 1 + the insertions of each shingle that landed in the table
    check(r["ok"].shape == seen.shape, "dedup: one insert success per ingested shingle")
    landed = seen & r["ok"]
    nu = oracle["uniq"].numel()
    seg = torch.cumsum(oracle["first"].to(torch.int64), 0) - 1     # sorted -> value id
    lsum = torch.zeros(nu, dtype=torch.int64, device=seen.device)
    lsum.index_add_(0, seg, landed[oracle["order"]].to(torch.int64))
    pos, hit = oracle["planted_pos"], oracle["planted_hit"]
    check(bool(hit.all()), "dedup: every planted shingle occurred in the stream")
    got = r["counts"].reshape(-1)
    want = 1 + lsum[pos]
    check(torch.equal(got, want), f"dedup: count_of equals 1 + landed insertions "
                                  f"({int((got != want).sum())} differ)")
    flag = torch.zeros(nu, dtype=torch.int64, device=seen.device)
    flag.index_add_(0, seg, (excess | (seen & ~r["ok"]))[oracle["order"]].to(torch.int64))
    off = got != oracle["count"][pos]
    r["count_off"], r["count_explained"] = int(off.sum()), int((off & (flag[pos] > 0)).sum())
    check(r["count_off"] == r["count_explained"],
          f"dedup: count_of equals the sightings but on {r['count_explained']} shingles "
          f"an excess or a failed insert explains ({r['count_off']} differ)")


def same_dedup(a: dict, b: dict) -> None:
    """Kernel and plain runs equal bit for bit: verdicts, fractions,
    counts, taps, the filter's words, the table's arrays, the cost log."""
    pairs = [(f"observe {i} {what}", x[j], y[j]) for i, (x, y) in
             enumerate(zip(a["observe"], b["observe"])) for j, what in
             enumerate(("dup_frac", "is_duplicate"))]
    pairs += [(f"observe_and_probe {what}", a["oap"][j], b["oap"][j]) for j, what in
              enumerate(("dup_frac", "is_duplicate", "probe fraction"))]
    pairs += [(name, a[name], b[name]) for name in ("counts", "seen", "probed", "ok")]
    pairs.append(("filter words", a["dedup"].bstate.words, b["dedup"].bstate.words))
    pairs += [(f"table {f}", getattr(a["dedup"].hstate, f), getattr(b["dedup"].hstate, f))
              for f in ("tkeys", "tvals", "status")]
    for what, x, y in pairs:
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"kernel and plain runs: dedup {what} bit-identical")
    check(a["costs"] == b["costs"], "kernel and plain runs: the same dedup cost log")


def dedup_roles() -> dict:
    """Roles of an observe's device time: the calls, callees included,
    each takes (the innermost role wins)."""
    return {"shingle hashing": (Deduper, "shingles"),
            "key hashing (hash_lanes_u64)": [(hm, "hash_lanes_u64"), (bl, "hash_lanes_u64")],
            "read bits (torch.bincount)": (hm, "_read_bits"),
            "bloom_insert (argsort, OR-scan)": (ops, "bloom_insert"),
            "insert_arrivals (copies, CSR, probe)": (ops, "bulk_insert_arrivals"),
            "exchange plan (commit, finish)": [(ExchangePlan, "commit"),
                                               (CommittedPlan, "finish")],
            "counting insert": (hm, "insert"), "bloom insert": (bl, "insert")}


#: the wire kernels' device functions by role: their C entry points launch
#: them outside any PyTorch op, so they are told apart by name (their
#: memsets count with the role around the call)
WIRE_DEVICE_NAMES = (("bo_rank_tiles", "bin_offsets"), ("pack_rows_kernel", "pack_rows"),
                     ("place_rows_kernel", "place_rows"), ("copy_words", "place_rows"))


#: the ctypes-launched kernels of an observe by name (the profiler links
#: them to no op): the wire's, the probes' CSR and probe, the Bloom words
DEDUP_DEVICE_NAMES = WIRE_DEVICE_NAMES + (
    ("csr_", "bin_csr"), ("probe_insert_blocks", "insert_arrivals kernel"),
    ("probe_find", "find_arrivals kernel"), ("hash_words_kernel", "hash_words"),
    ("membership_kernel", "membership"))


def dedup_split(r: dict, dd: dict) -> dict:
    """One observe of a batch on the kernel run's Deduper under
    torch.profiler: its device ms by role and by kernel, and the share of
    that same call's wall time the device was busy (the profiler's host
    cost is in that wall; the unprofiled observes' mean is printed beside
    it)."""
    trace: dict = {}
    roles = role_split(lambda: r["dedup"].observe(dd["batches"][1]), dedup_roles(),
                       DEDUP_DEVICE_NAMES, trace)
    busy = sum(trace["by_name"].values())
    by_kernel: dict[str, float] = {}
    for name, ms in list(trace["by_name"].items())[:10]:
        by_kernel[name[:60]] = by_kernel.get(name[:60], 0.0) + ms
    out = dict(wall_ms=trace["wall_ms"], device_ms=busy,
               device_busy_share=busy / trace["wall_ms"],
               unprofiled_observe_ms=1e3 * sum(r["observe_s"]) / len(r["observe_s"]),
               device_ms_by_role={k: v for k, v in roles.items() if v},
               device_ms_by_kernel=by_kernel)
    print("dedup split (one observe of 4096 documents): " + json.dumps(out), flush=True)
    return out


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

#: the valid-mask argument of each probe
_VALID_ARG = {"insert_arrivals": 4, "find_arrivals": 4, "insert": 6, "find": 5}


def _work(name: str, args: tuple) -> int:
    """Size of one call, to keep the largest a path makes."""
    if name in ("bin_offsets", "bin_csr"):
        return int(args[2].sum())
    if name == "pack_rows":
        return int(args[4].sum())
    if name == "place_rows":
        return int((args[1] < args[0].numel()).sum()) * args[2].shape[1]
    if name == "membership":
        return int(args[2].sum())
    if name in ("hash_words", "row_mix"):
        return args[0].shape[0]
    return int(args[_VALID_ARG[name]].sum())   # probes: valid queries


def capture_calls(sz: dict, data: dict, gz: dict, gdata: dict, xz: dict, xdata: dict,
                  dev) -> dict:
    """Run two insert waves and one find of the hash-map path, the
    genomics path with two walk steps and the extensions path's first two
    phases, recording each kernel's largest call, then one dense insert
    wave of the extensions path, recording its first bin_offsets and
    pack_rows calls and the CSR of its insert_arrivals call (under
    ``"wave"``: the calls most launches make).  No
    path reaches ragged_slots or histogram: they take the inputs of the extensions
    path's first pack_rows call and the bins of its largest
    multi_bin_offsets call.

    Both the wrapper and the plain version are tapped: on the CPU
    (rehearsal) the dispatcher calls the plain version directly.
    """
    seen: dict[str, tuple] = {}
    ext: dict[str, tuple] = {}
    wave_calls: dict[str, tuple] = {}
    probe = [""]
    originals = []
    for name, (mod, wrapper, plain, *_rest) in KERNELS.items():
        if name in OFF_PATH or name in FLOAT_KERNELS:
            continue
        for attr in (wrapper, plain):
            fn = getattr(mod, attr)
            originals.append((mod, attr, fn))

            def tap(*args, _name=name, _fn=fn):
                w = _work(_name, args)
                if w >= seen.get(_name, (-1,))[0]:
                    seen[_name] = (w, args)
                if probe[0] == "ext":
                    if _name == "pack_rows" and _name not in ext:
                        ext[_name] = (w, args)
                    if _name == "bin_offsets" and w >= ext.get(_name, (-1,))[0]:
                        ext[_name] = (w, args)
                if probe[0] == "wave" and _name in WIRE_KERNELS and _name not in wave_calls:
                    wave_calls[_name] = args
                if probe[0] == "wave" and _name == "insert_arrivals" \
                        and "bin_csr" not in wave_calls:
                    # the CSR the wave's probe builds (the plain probe builds none)
                    tk, _tv, _st, seg, valid, _mode = args
                    wave_calls["bin_csr"] = (seg[:, 0], tk.shape[0], valid)
                return _fn(*args)
            setattr(mod, attr, tap)
    try:
        main_path("auto", dict(sz, waves=2), dict(data, waves=data["waves"][:2]), dev)
        genomics_path("auto", gz, gdata, dev, steps=2)
        probe[0] = "ext"
        ext_path("auto", xz, xdata, dev, phases=(1, 2))
        # the extensions path's typical wire call: one dense insert wave
        probe[0] = "wave"
        bk, wave = SerialBackend(), xz["wave"]
        spec, st = hm.hashmap_create(bk, xz["capacity"], U32, U32, block_size=xz["block"],
                                     impl="auto", device=dev)
        k = xdata["keys"][:wave]
        hm.insert(bk, spec, st, u32(k), u32(value_of(k)), capacity=wave, transport="dense")
        del spec, st
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    if dev.type != "cuda" and "bin_csr" not in seen:
        # the plain probes build no CSR: take the one the card's largest
        # find_arrivals call builds
        tk, _tv, _st, seg, valid = seen["find_arrivals"][1]
        seen["bin_csr"] = (0, (seg[:, 0], tk.shape[0], valid))
    check(set(seen) == set(KERNELS) - set(OFF_PATH) - set(FLOAT_KERNELS),
          f"probe reached every kernel of the paths: {sorted(seen)}")
    calls = {name: args for name, (_, args) in seen.items()}
    rows, *slot_args, total = ext["pack_rows"][1]
    calls["ragged_slots"] = (*slot_args, total)     # sentinel = the buffer's size
    calls["histogram"] = ext["bin_offsets"][1]
    check(set(wave_calls) == {*WIRE_KERNELS, "bin_csr"}, f"a wave reached {sorted(wave_calls)}")
    calls["wave"] = wave_calls
    return calls


def ptxas_report(log: str) -> dict:
    """Registers and spills of each kernel in an ``nvcc -Xptxas -v`` log,
    by (mangled) entry function name; ptxas's remarks on wgmma and
    setmaxnreg (C75xx: injected waits, serialised wgmma) under "remarks"."""
    out, fn = {}, None
    for line in log.splitlines():
        if "(C75" in line:
            out["remarks"] = (out.get("remarks", "") + " | " + line.strip()).strip(" |")
        elif "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("spill" in line or "registers" in line):
            out[fn] = (out.get(fn, "") + " " + line.replace("ptxas info    :", "").strip()).strip()
    return out


def tensor_core_sass(lib: Path, kernel: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each function of ``lib``
    whose name holds ``kernel``, counted in ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and kernel in fn and ("HMMA" in line or "HGMMA" in line):
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def time_ms(fn, reps: int, dev) -> float:
    fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_bytes(name: str, args: tuple, out) -> int:
    """Bytes the function must move: each input read once, each output
    written once; the find reads only the blocks its queries touch."""
    outs = out if isinstance(out, tuple) else (out,)
    if name in ("find_arrivals", "find"):
        if name == "find":
            tk, tv, st, qblock, qkeys, valid = args
        else:
            tk, tv, st, seg, valid = args
            qblock, qkeys = seg[:, 0], seg[:, 1:1 + tk.shape[2]]
        nb, bsz, lk = tk.shape
        lv = tv.shape[2]
        blocks = torch.unique(qblock[valid]).numel()
        hits = int(outs[0].sum())
        return (blocks * bsz * (lk + 1) * 4 + hits * lv * 4
                + qblock.numel() * 4 + qkeys.shape[0] * lk * 4 + _nbytes(valid, *outs))
    if name == "insert_arrivals":
        tk, tv, st, seg, valid, _mode = args
        rows = seg.shape[0] * (1 + tk.shape[2] + tv.shape[2]) * 4
        return _nbytes(tk, tv, st, valid, *outs) + rows
    return _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *outs)


def bound_ops(name: str, args: tuple) -> int:
    """32-bit integer operations the function does on these inputs (a
    floor: compares, masks and address arithmetic per word or slot)."""
    if name == "bin_offsets":
        return 24 * args[0].numel()            # count, scan, ordered rank passes
    if name == "bin_csr":                     # per item and digit: the digit (shift,
        passes = len(binning.digit_widths(args[1]))   # mask), its rank (count, add)
        return 4 * passes * args[0].numel()
    if name == "pack_rows":
        return 12 * args[0].numel()            # window test + slot per word
    if name == "place_rows":
        return 6 * args[2].numel() + args[0].numel()
    if name == "membership":
        return 6 * args[0].shape[0]            # two and-compares, valid, combine
    if name == "hash_words":
        m, lanes = args[0].shape               # two hashes (8 per fmix32, 11 per
        return m * (21 + 22 * lanes + 6 * args[1])    # lane) and 6 per bit
    if name == "row_mix":
        m, lanes = args[0].shape               # a multiply-add per lane, fmix32
        return m * (2 * lanes + 8)
    if name == "ragged_slots":
        return 12 * args[0].numel()            # window test + slot per item
    if name == "histogram":
        return 4 * args[0].numel()             # range test, match, count per item
    tk = args[0]
    probes = int(args[_VALID_ARG[name]].sum())
    return probes * tk.shape[1] * (tk.shape[2] + 3)   # key compare + state test per slot


def max_abs_err(a, b) -> int:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    check(len(a) == len(b), "kernel and plain return the same outputs")
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype, "same shapes and types")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def csr_key(bins: torch.Tensor, nbins: int, valid: torch.Tensor) -> torch.Tensor:
    """The int32 key whose stable sort is the CSR's order: the bin of a live
    item, ``nbins`` for the rest."""
    return torch.where(valid & (bins >= 0) & (bins < nbins), bins, nbins).to(torch.int32)


def library_call(name: str, args: tuple):
    """One PyTorch call computing the same function, where there is one:
    place_rows is ``Tensor.index_put`` of the landing words (the drop mask
    and word indices are prepared outside the timed call); histogram is
    ``torch.bincount`` weighted by the valid mask (float64 sums, exact
    below 2**53), cast back to int32 outside the timed call; bin_csr is
    ``torch.sort(stable=True)`` of the int32 key (:func:`csr_key`, made
    outside the timed call), whose indices are the order (the starts need
    a ``searchsorted`` more)."""
    if name == "histogram":
        bins, nbins, valid = args
        return lambda: torch.bincount(bins, weights=valid, minlength=nbins)
    if name == "bin_csr":
        key = csr_key(*args)
        return lambda: torch.sort(key, stable=True)
    if name != "place_rows":
        return None
    dst, slots, rows = args
    w = rows.shape[1]
    idx = slots.to(torch.int64)[:, None] + torch.arange(w, device=dst.device)
    keep = (slots[:, None] >= 0) & (idx < dst.numel())
    idx, vals = idx[keep], rows[keep]
    return lambda: dst.index_put((idx,), vals)


def wire_regime(name: str, args: tuple) -> dict:
    """What sets a wire kernel's regime: its items, bins, flows, row
    width and buffer words."""
    if name == "bin_offsets":
        bins, nbins, valid = args
        return dict(items=bins.shape[0], nbins=nbins, valid=int(valid.sum()))
    rows, _bins, _flow, _off, valid, rnd, woff, _rw, _caps, _rnds, wtot, total = args
    return dict(items=rows.shape[0], wmax=rows.shape[1], nflows=woff.shape[0],
                valid=int(valid.sum()), rnd=rnd, wtot=wtot, total=total)


def device_ms(fn, reps: int) -> dict:
    """Device ms and launches per call of each kernel ``fn`` runs, by the
    profiler's name (memsets and copies included), under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, dict] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            row = out.setdefault(ev.key, dict(ms=0.0, launches=0.0))
            row["ms"] += ev.self_device_time_total / 1e3 / reps
            row["launches"] += ev.count / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def short_names(split: dict, top: int = 8) -> dict:
    """The ``top`` entries of a :func:`device_ms` split, keyed by the first
    60 characters of each name for printing (entries whose names share
    them are added together)."""
    out: dict[str, dict] = {}
    for key, v in list(split.items())[:top]:
        row = out.setdefault(key[:60], {k: 0.0 for k in v})
        for k in v:
            row[k] += v[k]
    return out


#: bin counts of the wire split's bin_offsets sweep: the paths' (one rank:
#: one bin per flow) up to one launch's most
WIRE_BINS = (1, 2, 3, 8, 32, 64, 128, 255, 512, 1023)


def wire_split(calls: dict, reps: int, dev, seed: int) -> dict:
    """bin_offsets and pack_rows at the kernel phase's call (the largest a
    path makes) and at the extensions path's wave call (2**19 items, where
    most launches are): each held bit for bit against its plain version,
    the wrapper's ms (CUDA events) and, on the card, the device ms and
    launches of each kernel it runs (torch.profiler).  Then bin_offsets
    at both item counts over :data:`WIRE_BINS` bins (random bins, every
    tenth item invalid, as at many ranks), held and timed the same way
    (at the wave's count the wrapper's time is the host's: read device
    ms there)."""
    out = {}
    for label, at in (("kernel phase", calls), ("wave", calls["wave"])):
        for name in WIRE_KERNELS:
            args = at[name]
            fn, plain = getattr(binning, name), getattr(binning, name + "_plain")
            got, want = fn(*args), plain(*args)
            sync(dev)
            check(max_abs_err(got, want) == 0,
                  f"{name} at the {label} call: kernel equals its plain version bit for bit")
            row = dict(regime=wire_regime(name, args), ms=time_ms(lambda: fn(*args), reps, dev))
            if dev.type == "cuda":
                split = device_ms(lambda: fn(*args), reps)
                row.update(device_ms=sum(v["ms"] for v in split.values()),
                           launches=sum(v["launches"] for v in split.values()),
                           device_ms_by_kernel=short_names(split))
            out[name, label] = row
            print(f"wire split {name} {label}: " + json.dumps(row), flush=True)
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    for n in (calls["bin_offsets"][0].shape[0], calls["wave"]["bin_offsets"][0].shape[0]):
        valid = torch.rand(n, generator=g, device=dev) >= 0.1
        for nbins in WIRE_BINS:
            bins = torch.randint(0, nbins, (n,), generator=g, device=dev, dtype=torch.int32)
            check(max_abs_err(binning.bin_offsets(bins, nbins, valid),
                              binning.bin_offsets_plain(bins, nbins, valid)) == 0,
                  f"bin_offsets at {n} items into {nbins} bins: equal to the plain version")
            call = lambda: binning.bin_offsets(bins, nbins, valid)  # noqa: E731
            row = dict(items=n, nbins=nbins, ms=time_ms(call, reps, dev))
            if dev.type == "cuda":
                split = device_ms(call, reps)
                row.update(device_ms=sum(v["ms"] for v in split.values()),
                           launches=sum(v["launches"] for v in split.values()))
            out["bins", n, nbins] = row
            print("wire split bin_offsets bins: " + json.dumps(row), flush=True)
    return out


def csr_split(calls: dict, reps: int, dev) -> dict:
    """bin_csr at the kernel phase's call (the largest a path makes) and at
    the CSR of an extensions wave's insert (2**19 items into 2**20 blocks):
    held bit for bit against its plain version, the wrapper's ms (CUDA
    events), its device ms and launches by kernel (torch.profiler; memsets
    included) and the library's stable sort of its int32 key."""
    out = {}
    for label, args in (("kernel phase", calls["bin_csr"]), ("wave", calls["wave"]["bin_csr"])):
        check(max_abs_err(binning.bin_csr(*args), binning.bin_csr_plain(*args)) == 0,
              f"bin_csr at the {label} call: kernel equals its plain version bit for bit")
        bins, nbins, valid = args
        row = dict(items=bins.shape[0], nbins=nbins, valid=int(valid.sum()),
                   ms=time_ms(lambda: binning.bin_csr(*args), reps, dev))
        key = csr_key(*args)
        row["sort_ms"] = time_ms(lambda: torch.sort(key, stable=True), reps, dev)
        if dev.type == "cuda":
            split = device_ms(lambda: binning.bin_csr(*args), reps)
            row.update(device_ms=sum(v["ms"] for v in split.values()),
                       launches=sum(v["launches"] for v in split.values()),
                       device_ms_by_kernel=short_names(split))
        out[label] = row
        print(f"csr split bin_csr {label}: " + json.dumps(row), flush=True)
    return out


def kernel_phase(calls: dict, reps: int, dev) -> dict:
    rows = {}
    for name, (mod, wrapper, plain, _src, _rep) in KERNELS.items():
        if name in FLOAT_KERNELS:
            continue
        args = calls[name]
        got = getattr(mod, wrapper)(*args)
        want = getattr(mod, plain)(*args)
        sync(dev)
        err = max_abs_err(got, want)
        check(err == 0, f"{name}: kernel equals its plain version bit for bit")
        lib = library_call(name, args)
        if lib is not None:
            out = lib()
            same = (torch.equal(out.indices.to(torch.int32), got[0]) if name == "bin_csr"
                    else torch.equal(out.to(got.dtype), got))
            check(same, f"{name}: library call computes the same")
        bytes_ms = bound_bytes(name, args, got) / HBM_BYTES_PER_S * 1e3
        ops_ms = bound_ops(name, args) / OPS_PER_S * 1e3
        rows[name] = dict(
            **({"regime": wire_regime(name, args)} if name in WIRE_KERNELS else {}),
            max_abs_err=err,
            ms=time_ms(lambda: getattr(mod, wrapper)(*args), reps, dev),
            plain_ms=time_ms(lambda: getattr(mod, plain)(*args), max(1, reps // 5), dev),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None if lib is None else time_ms(lib, reps, dev),
            shape=[list(a.shape) for a in args if isinstance(a, torch.Tensor)])
        print(f"kernel {name}: " + json.dumps(rows[name]), flush=True)
    return rows


#: bin_csr's device kernels as the profiler names them (the first five
#: are the earlier design's, so a run against an older checkout splits too)
CSR_KERNELS = ("bd_count", "bo_scan", "bd_starts", "bd_place", "csr_finish", "csr_count",
               "csr_pass", "csr_starts")
#: device kernels of the probes by role, as the profiler names them (the
#: first names are the earlier warp-per-block walk and warp-per-query
#: find, so a run against an older checkout splits its time too)
PROBE_ROLES = (
    ("probe", ("insert_arrivals_kernel", "find_arrivals_kernel", "insert_kernel",
               "find_kernel", "probe_insert_blocks", "probe_find_blocks",
               "probe_find_queries")),
    ("csr", CSR_KERNELS),
    ("clone", ("Memcpy DtoD",)),
    ("memset", ("Memset",)),
)


def csr_argsort(qblock: torch.Tensor, valid: torch.Tensor, nb: int):
    """The probes' CSR as the earlier wrapper built it, kept as a yardstick:
    a bincount, a cumsum and a stable int64 argsort of every arrival."""
    b = torch.where(valid, qblock.to(torch.int64), nb)
    counts = torch.bincount(b, minlength=nb + 1)
    start = torch.zeros(nb + 1, dtype=torch.int64, device=qblock.device)
    start[1:] = torch.cumsum(counts[:nb], 0)
    return torch.argsort(b, stable=True).to(torch.int32), start.to(torch.int32)


def large_bins_case(sz: dict, dev, seed: int) -> dict:
    """bin_offsets past one kernel pass's bins: 2**24 items (every tenth
    invalid) into 2**20 bins, held bit for bit against the plain version
    (counts, and every offset: invalid items rank among the invalid ones),
    timed beside it."""
    n, nbins = sz["large_bins"]
    g = torch.Generator(device="cpu").manual_seed(seed + 3)
    bins = torch.randint(0, nbins, (n,), generator=g, dtype=torch.int32).to(dev)
    valid = (torch.rand(n, generator=g) >= 0.1).to(dev)
    got = binning.bin_offsets(bins, nbins, valid)
    want = binning.bin_offsets_plain(bins, nbins, valid)
    sync(dev)
    err = max_abs_err(got, want)
    check(err == 0, "bin_offsets large_bins: kernel equals its plain version bit for bit")
    bytes_ms = bound_bytes("bin_offsets", (bins, nbins, valid), got) / HBM_BYTES_PER_S * 1e3
    ops_ms = bound_ops("bin_offsets", (bins, nbins, valid)) / OPS_PER_S * 1e3
    row = dict(max_abs_err=err, ms=time_ms(lambda: binning.bin_offsets(bins, nbins, valid),
                                           sz["reps"], dev),
               plain_ms=time_ms(lambda: binning.bin_offsets_plain(bins, nbins, valid),
                                max(1, sz["reps"] // 5), dev),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               shape=dict(items=n, bins=nbins))
    print("kernel bin_offsets large_bins: " + json.dumps(row), flush=True)
    return row


def find_routes(sz: dict, dev, seed: int) -> dict:
    """find_arrivals' two CUDA routes timed at densities on either side of
    ``hash_probe.DENSE_QUERIES`` (the route is forced through that
    threshold), each held against the plain version: random blocks over
    the hash-map path's table shape, half the queries stored keys."""
    if dev.type != "cuda":
        return {}
    nb, bsz = sz["capacity"] // sz["block"], sz["block"]
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    tk = torch.randint(-2**31, 2**31 - 1, (nb, bsz, 1), generator=g, device=dev,
                       dtype=torch.int32)
    tv = torch.randint(-2**31, 2**31 - 1, (nb, bsz, 1), generator=g, device=dev,
                       dtype=torch.int32)
    st = torch.where(torch.rand((nb, bsz), generator=g, device=dev) < 0.5, 2, 0).to(torch.int32)
    real, rows = hash_probe.DENSE_QUERIES, {}
    try:
        for per_block in (0.125, 0.5, 2, 8):
            m = int(per_block * nb)
            blk = torch.randint(0, nb, (m,), generator=g, device=dev, dtype=torch.int32)
            slot = torch.randint(0, bsz, (m,), generator=g, device=dev)
            key = torch.where(torch.arange(m, device=dev) % 2 == 0, tk[blk.long(), slot, 0],
                              torch.randint(-2**31, 2**31 - 1, (m,), generator=g, device=dev,
                                            dtype=torch.int32))
            seg = torch.stack([blk, key], 1)
            valid = torch.ones(m, dtype=torch.bool, device=dev)
            want = hash_probe.find_arrivals_plain(tk, tv, st, seg, valid)
            row = {}
            for route, threshold in (("block_major", 0), ("per_query", float("inf"))):
                hash_probe.DENSE_QUERIES = threshold
                got = hash_probe.find_arrivals(tk, tv, st, seg, valid)
                check(max_abs_err(got, want) == 0, f"find_arrivals {route} route at "
                      f"{per_block} queries a block: equal to the plain version")
                row[route + "_ms"] = time_ms(
                    lambda: hash_probe.find_arrivals(tk, tv, st, seg, valid), sz["reps"], dev)
            hash_probe.DENSE_QUERIES = real
            row["taken"] = "block_major" if m >= real * nb else "per_query"
            rows[per_block] = row
            print(f"find routes at {per_block} queries a block ({m} over {nb} blocks of "
                  f"{bsz}): " + json.dumps(row), flush=True)
    finally:
        hash_probe.DENSE_QUERIES = real
    return rows


def probe_split(calls: dict, reps: int, dev) -> dict:
    """Where each probe's time goes at its kernel-phase call: the wrapper's
    time (CUDA events), its device time by role under torch.profiler
    (the probe kernel, the CSR's kernels, table copies, memsets, and the
    rest: PyTorch glue), and the CSR built both ways
    (``hash_probe.bin_queries``), beside the library's stable sort of its
    int32 key and the bincount + int64 argsort yardstick."""
    out = {}
    for name in ("insert_arrivals", "find_arrivals", "insert", "find"):
        args = calls[name]
        fn = getattr(hash_probe, name)
        row = dict(ms=time_ms(lambda: fn(*args), reps, dev))
        if dev.type == "cuda":
            roles: dict[str, float] = {}
            kernels = device_ms(lambda: fn(*args), reps)
            for key, v in kernels.items():
                role = next((r for r, keys in PROBE_ROLES if any(k in key for k in keys)),
                            "glue")
                roles[role] = roles.get(role, 0.0) + v["ms"]
            row.update(device_ms_by_role=roles, device_ms_by_kernel={
                key: v["ms"] for key, v in short_names(kernels).items()})
        nb, valid = args[0].shape[0], args[_VALID_ARG[name]]
        qblock = args[3] if name in ("insert", "find") else args[3][:, 0]
        row["csr_ms"] = time_ms(lambda: hash_probe.bin_queries(qblock, valid, nb), reps, dev)
        key = csr_key(qblock, nb, valid)
        row["csr_sort_ms"] = time_ms(lambda: torch.sort(key, stable=True), reps, dev)
        row["csr_argsort_ms"] = time_ms(lambda: csr_argsort(qblock, valid, nb), reps, dev)
        out[name] = row
        print(f"probe split {name}: " + json.dumps(row), flush=True)
    return out


def attention_pairs(tq: int, tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work these inputs need."""
    pairs = 0
    for i in range(tq):
        qpos = i + tk - tq
        hi = min(tk - 1, qpos) if causal else tk - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def f32_within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Float32 attention outputs within atol = rtol = 3e-5 elementwise."""
    w = want.float()
    return bool(((got.float() - w).abs() <= 3e-5 + 3e-5 * w.abs()).all())


def attention_close(got: torch.Tensor, want: torch.Tensor, what: str,
                    per_element: bool = True, weighted: torch.Tensor | None = None
                    ) -> tuple[float, str]:
    """Fail unless ``got`` is within the attention tolerance of ``want``:
    float32 at atol = rtol = 3e-5 elementwise (the online softmax sums in
    another order); bf16 elementwise at rtol BF16_RTOL, atol BF16_ATOL.
    ``weighted`` (a ``probs_bf16`` call: the attention-weighted mean of
    |V|, float32) adds PROBS_BF16_RTOL of it to each element's tolerance.
    ``per_element=False`` holds the output only at one bf16 ulp of its
    scale, 1e-2 * max|want|: for the library call, a yardstick that
    rounds the probabilities to bf16 before multiplying by V (and may
    take float32 through TF32).
    Returns (max |got - want|, the tolerance)."""
    g, w = got.float(), want.float()
    check(got.shape == want.shape and got.dtype == want.dtype and bool(torch.isfinite(g).all()),
          f"{what}: finite outputs of the plain version's shape and type")
    diff = (g - w).abs()
    err = float(diff.max())
    if not per_element:
        scale = 1e-2 * float(w.abs().max())
        tol, ok = f"atol={scale:.4g}", err <= scale
    elif weighted is not None:
        atol, rtol, tol = ((3e-5, 3e-5, "atol=rtol=3e-5") if got.dtype == torch.float32 else
                           (BF16_ATOL, BF16_RTOL, f"atol={BF16_ATOL:g} rtol=2**-7"))
        tol += " + 2**-8 * (P |V|)"
        ok = bool((diff <= atol + rtol * w.abs() + PROBS_BF16_RTOL * weighted).all())
    elif got.dtype == torch.float32:
        tol, ok = "atol=rtol=3e-5", f32_within(got, want)
    else:
        tol = f"atol={BF16_ATOL:g} rtol=2**-7"
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * w.abs()).all())
    check(ok, f"{what}: max |difference| {err}, tolerance {tol}")
    return err, tol


def flash_instance_check(case: str, dtype, d: int, pb: bool) -> None:
    """The instance the wrapper reports it launched takes head dim ``d``
    and has the call's probs_bf16 flag (launch counts are kept by route,
    not by instance)."""
    route = "bf16" if dtype == BF16 else "f32"
    rows = fa.bf16_instances() if dtype == BF16 else fa.f32_instances()
    i = fa.last_instance[route]
    check(0 <= i < len(rows) and rows[i]["probs_bf16"] == pb and rows[i]["max_d"] >= d,
          f"flash_attention {case}: the {route} route launched an instance with "
          f"probs_bf16={pb} for D={d} (instance {i}: {rows[i] if 0 <= i < len(rows) else None})")


def flag_changes_output(case: str, flagged: torch.Tensor, unflagged: torch.Tensor) -> None:
    """A probs_bf16 call's kernel output against the same kernel's without
    the flag: float32 must differ beyond the route's own gate (bf16 V alone
    moves an element by up to 2**-9 of it); bf16 (inputs already bf16, only
    P's rounding differs, mostly inside the output's own bf16 rounding) must
    not be bit-identical."""
    diff = float((flagged.float() - unflagged.float()).abs().max())
    if flagged.dtype == torch.float32:
        ok = not f32_within(flagged, unflagged)
        what = "beyond atol=rtol=3e-5"
    else:
        ok = not torch.equal(flagged, unflagged)
        what = "not bit-identical"
    print(f"flash_attention {case}: probs_bf16 vs the same kernel without it, max |difference| "
          f"{diff} ({what} required)", flush=True)
    check(ok, f"flash_attention {case}: probs_bf16 changes the kernel's output ({what})")


def flash_phase(cases: dict, reps: int, dev, seed: int) -> dict:
    """flash_attention against its plain version on each case; kernel,
    plain and (the cases the JSON rows report, and the MLA and probs_bf16
    cases) scaled_dot_product_attention times, and on the card the
    kernel's device time (torch.profiler: the wrapper's host time left
    out); the bound from the pairs the mask keeps (2 D flops each for S,
    2 Dv for P V, Dv the columns of V that are real) at the route's peak
    (bf16: one pass at the bf16 rate; float32: three TF32 passes at the
    TF32 rate, with the CUDA-core floor, one pass at the float32 rate,
    beside it as cuda_core_ms; a probs_bf16 P V at the bf16 rate) and from
    the bytes (q, k and the real columns of v read once, the output's
    real columns written once).  A case with ``v_cols`` (FLASH_OPTIONS)
    has V's columns past them zero, as MLA pads them, and is also timed
    beside the library call on V at its real width."""
    rows = {}
    for i, (case, (b, hq, hkv, tq, tk, d, causal, window, dtype)) in enumerate(cases.items()):
        opts = FLASH_OPTIONS.get(case, {})
        pb = opts.get("probs_bf16", False)
        dv = round(d * opts.get("v_cols", 1))
        g = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
        v[..., dv:] = 0

        def kern():
            return fa.flash_attention(q, k, v, causal=causal, window=window, probs_bf16=pb)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                            probs_bf16=pb)
        before = build.launch_counts()
        got, want = kern(), plain()
        sync(dev)
        if dev.type == "cuda":
            route = "flash_attention" if dtype == BF16 else "flash_attention_f32"
            ran = {n: c - before[n] for n, c in build.launch_counts().items() if c != before[n]}
            check(ran == {route: 1}, f"flash_attention {case}: one launch of {route}, {ran}")
            flash_instance_check(case, dtype, d, pb)
            if "instance_d" in opts:
                inst = (fa.bf16_instances() if dtype == BF16 else fa.f32_instances())[
                    fa.last_instance["bf16" if dtype == BF16 else "f32"]]
                check(inst["max_d"] == opts["instance_d"]
                      and all(fa._aligned_operand(t, d) is t for t in (q, k, v)),
                      f"flash_attention {case}: the D<={opts['instance_d']} instance on the "
                      f"operands as they are (launched {inst})")
        weighted = (fa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                             causal=causal, window=window) if pb else None)
        err, tol = attention_close(got, want, f"flash_attention {case}: kernel vs plain",
                                   weighted=weighted)
        del weighted
        if pb and dev.type == "cuda":
            flag_changes_output(case, got, fa.flash_attention(q, k, v, causal=causal,
                                                              window=window))
        check(not bool(got[..., dv:].any()), f"flash_attention {case}: V's zero columns stay 0")
        pairs = b * hq * attention_pairs(tq, tk, causal, window)
        s_flops, pv_flops = 2 * d * pairs, 2 * dv * pairs
        if dtype == BF16:
            ops_ms = (s_flops + pv_flops) / BF16_OPS_PER_S * 1e3
        else:
            ops_ms = (3 * s_flops / TF32_OPS_PER_S + (pv_flops / BF16_OPS_PER_S if pb else
                                                      3 * pv_flops / TF32_OPS_PER_S)) * 1e3
        bytes_ms = (_nbytes(q, k) + (v.numel() + got.numel()) * dv // d * v.element_size()
                    ) / HBM_BYTES_PER_S * 1e3
        library_ms = None
        if case in SDPA_CASES:
            mask = None
            if window:      # the window as a boolean mask (the library has no window)
                qpos = torch.arange(tq, device=dev)[:, None] + (tk - tq)
                kpos = torch.arange(tk, device=dev)[None, :]
                mask = (kpos > qpos - window) & ((kpos <= qpos) if causal else True)

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      is_causal=causal and mask is None,
                                                      enable_gqa=True)
            attention_close(library(), want, f"flash_attention {case}: the library call",
                            per_element=False)
            library_ms = time_ms(library, reps, dev)
        rows[case] = row = dict(
            max_abs_err=err, tol=tol, ms=time_ms(kern, reps, dev),
            plain_ms=time_ms(plain, max(1, reps // 5), dev),
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=library_ms,
            shape=dict(q=[b, hq, tq, d], kv=[b, hkv, tk, d], v_cols=dv, causal=causal,
                       window=window, dtype=str(dtype), probs_bf16=pb))
        if dv < d and case in SDPA_CASES:
            # the library call on V at its real width (a fused backend may take Dv < D)
            v_real = v[..., :dv].contiguous()

            def library_real():
                return F.scaled_dot_product_attention(q, k, v_real, is_causal=causal,
                                                      enable_gqa=True)
            attention_close(library_real(), want[..., :dv].contiguous(),
                            f"flash_attention {case}: the library call at Dv={dv}",
                            per_element=False)
            row["library_real_v_ms"] = time_ms(library_real, reps, dev)
            row["sdpa_real_v_ratio"] = row["ms"] / row["library_real_v_ms"]
            del v_real
        if dtype == F32:
            row["cuda_core_ms"] = (s_flops + pv_flops) / OPS_PER_S * 1e3
        if dev.type == "cuda":   # the kernel alone, without the wrapper's host time
            row["device_ms"] = sum(v["ms"] for v in device_ms(kern, reps).values())
        if library_ms is not None:
            row["sdpa_ratio"] = row["ms"] / library_ms    # kernel / the library call
        print(f"kernel flash_attention {case}: " + json.dumps(row), flush=True)
        del q, k, v, got, want
    return rows


# --------------------------------------------------------------------------
# the serving path: qwen3-4b through the port's serve loop
# --------------------------------------------------------------------------

def _tree_sum(tree, leaf=torch.Tensor.numel) -> int:
    """``leaf`` summed over the tensors of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return sum(_tree_sum(v, leaf) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_sum(v, leaf) for v in tree)
    return leaf(tree)


def _tree_bytes(tree) -> int:
    return _tree_sum(tree, lambda t: t.numel() * t.element_size())


def serving_setup(vz: dict, dev, seed: int) -> dict:
    """The model (seeded init_params on the card) and serve.py's prompts."""
    cfg = get_config(vz["arch"])
    if vz["reduced"]:
        cfg = reduced(cfg)
    sync(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                   (vz["requests"], vz["prompt_len"]),
                                                   dtype=np.int32)
    n_params = _tree_sum(params)
    print(f"serving model: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters ({cfg.dtype}), init {init_s:.2f}s", flush=True)
    return dict(cfg=cfg, params=params, n_params=n_params, label=f"{cfg.name} serving",
                prompts=torch.from_numpy(prompts).to(dev), embeds={})


def rows_of(embeds: dict, rows) -> dict:
    """The frontend embeddings (``patch_embeds`` / ``src_embeds``) of ``rows``."""
    return {k: e[rows] for k, e in embeds.items()}


def n_patches(embeds: dict) -> int:
    """Positions the patches take before the text (0 without them)."""
    return embeds["patch_embeds"].shape[1] if "patch_embeds" in embeds else 0


def serving_path(impl: str, vz: dict, sv: dict, forced=None) -> dict:
    """``serve`` over every request (with each one's frontend embeddings);
    each wave's prefill and decode logits kept."""
    logits, timings = {}, {}
    tokens = serve(sv["params"], sv["cfg"], sv["prompts"], vz["batch"], vz["gen"], impl,
                   forced=forced, on_logits=lambda w, st, lg: logits.__setitem__((w, st), lg),
                   timings=timings, **sv["embeds"])
    return dict(tokens=tokens, logits=logits, timings=timings, impl=impl,
                window_cache=sv["cfg"].window_cache)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def check_serving(r: dict, vz: dict, sv: dict) -> None:
    """Finite logits, gen in-vocab tokens per request, and prefill/decode
    consistency on wave 0: decode step n's logits equal the last-position
    logits of a prefill of prompt + tokens[:n] (n = 1 and gen), with the
    rows' frontend embeddings (what the cache carries: K/V, recurrent
    state, an encoder-decoder's cross K/V)."""
    cfg, vocab = sv["cfg"], sv["cfg"].vocab
    n_waves = -(-vz["requests"] // vz["batch"])
    check(sorted(r["logits"]) == [(w, s) for w in range(n_waves) for s in range(vz["gen"] + 1)],
          "serving: one prefill and gen decode steps of logits per wave")
    for key, lg in r["logits"].items():
        check(bool(torch.isfinite(lg).all()), f"serving: finite logits at (wave, step) {key}")
    toks = r["tokens"]
    check(len(toks) == vz["requests"] and all(
        len(t) == vz["gen"] and all(0 <= x < vocab for x in t) for t in toks.values()),
        "serving: gen in-vocab tokens per request")
    rows = list(range(min(vz["batch"], vz["requests"])))
    gen_toks = torch.tensor([toks[i] for i in rows], device=sv["prompts"].device)
    r["consistency"] = {}
    for n in (1, vz["gen"]):
        seq = torch.cat([sv["prompts"][rows], gen_toks[:, :n].to(sv["prompts"].dtype)], dim=1)
        _, last = lm.prefill(sv["params"], cfg, {"tokens": seq, **rows_of(sv["embeds"], rows)},
                             cache_len=n_patches(sv["embeds"]) + seq.shape[1], impl=r["impl"])
        r["consistency"][n] = rel_l2(r["logits"][0, n][rows, :vocab], last[:, :vocab])
    print(f"{sv['label']} ({r['impl']}): decode step n vs prefill of prompt + n tokens, "
          f"relative L2 {r['consistency']}", flush=True)
    for n, err in r["consistency"].items():
        check(err <= SERVE_REL_L2, f"serving: decode step {n} vs prefill of prompt + "
                                   f"{n} tokens, relative L2 {err} <= {SERVE_REL_L2}")


def first_attention(sv: dict, tokens: torch.Tensor, impl: str, embeds=None) -> torch.Tensor:
    """The first layer's attention output (B, T, d_model), tapped where
    ``lm.forward`` of the model cut to that layer calls the attention
    (``mla_attention`` for an MLA model); ``embeds``: a decoder-only
    model's ``patch_embeds`` before the tokens."""
    cfg = dataclasses.replace(sv["cfg"], n_layers=1)
    params = dict(sv["params"], layers=sv["params"]["layers"][:1])
    name = "mla_attention" if cfg.mla is not None else "attention"
    real, seen = getattr(lm.attn_mod, name), []

    def tap(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[0])
        return out
    setattr(lm.attn_mod, name, tap)
    try:
        lm.forward(params, cfg, tokens, impl=impl, **(embeds or {}))
    finally:
        setattr(lm.attn_mod, name, real)
    return seen[0].float()


def position_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest relative L2 gap over positions (the last dim) of a to b."""
    a, b = a.float(), b.float()
    return float((torch.linalg.vector_norm(a - b, dim=-1)
                  / torch.linalg.vector_norm(b, dim=-1)).max())


def first_layer_gap(sv: dict, tokens: torch.Tensor, embeds=None) -> float:
    """Largest per-position relative L2 gap between the first layer's
    attention outputs through the kernel and through the plain version."""
    return position_gap(first_attention(sv, tokens, "auto", embeds),
                        first_attention(sv, tokens, "torch", embeds))


def _lose_oldest_tile(real):
    def fault(q, k, v, causal=True, window=0, **kw):
        return real(q, k, v, causal=causal,
                    window=window - 64 if window > 64 else max(1, k.shape[2] - 64), **kw)
    return fault


def _see_next_key(real):
    def fault(q, k, v, causal=True, window=0, **kw):
        return real(q, torch.cat([k, k[:, :, -1:]], 2), torch.cat([v, v[:, :, -1:]], 2),
                    causal=causal, window=window, **kw)
    return fault


#: faults planted around the kernel's wrapper: what the serving checks see
PLANTED_FAULTS = {"rows lose up to one 64-key tile (the oldest of a full window, or "
                  "the last 64 rows' first tile)": _lose_oldest_tile,
                  "causal off by one (each row sees the next key)": _see_next_key}


def planted_faults(sv: dict, tokens: torch.Tensor, plain_logits: torch.Tensor) -> None:
    """Each planted fault must break the first-layer check; the gap of
    the whole model's prefill logits to the plain run's is printed beside
    SERVE_REL_L2."""
    real, vocab = fa.flash_attention, sv["cfg"].vocab
    for name, plant in PLANTED_FAULTS.items():
        fa.flash_attention = plant(real)
        try:
            gap = first_layer_gap(sv, tokens)
            _, lg = lm.prefill(sv["params"], sv["cfg"], {"tokens": tokens},
                               cache_len=tokens.shape[1])
        finally:
            fa.flash_attention = real
        err = rel_l2(lg[:, :vocab], plain_logits[:, :vocab])
        print(f"{sv['label']}: planted fault '{name}': first-layer gap {gap:.6f} "
              f"(limit {LAYER_REL_L2}); prefill logits relative L2 {err:.6f} "
              f"({'above' if err > SERVE_REL_L2 else 'within'} {SERVE_REL_L2})", flush=True)
        check(gap > LAYER_REL_L2, f"serving: the first-layer check catches '{name}'")


def same_logits(a: dict, b: dict, vz: dict, sv: dict) -> None:
    """The plain run, teacher-forced with the kernel run's tokens: every
    step's logits within SERVE_REL_L2 of the kernel run's."""
    vocab, batch, gen = sv["cfg"].vocab, vz["batch"], vz["gen"]
    errs = {key: rel_l2(b["logits"][key][:, :vocab], a["logits"][key][:, :vocab])
            for key in a["logits"]}
    worst = max(errs, key=errs.get)
    prefill = [round(e, 6) for (_, st), e in sorted(errs.items()) if st == 0]
    # the plain run's own greedy pick where the kernel run's token was fed
    agree = sum(int(b["logits"][w, st][j].argmax()) == a["tokens"][w * batch + j][st]
                for (w, st) in b["logits"] if st < gen
                for j in range(batch) if w * batch + j in a["tokens"])
    total = sum(len(t) for t in a["tokens"].values())
    print(f"{sv['label']}: kernel vs plain logits, relative L2: max {errs[worst]:.6f} at "
          f"(wave, step) {worst}, prefill waves {prefill}, mean "
          f"{sum(errs.values()) / len(errs):.6f}; plain greedy picks equal to the kernel "
          f"run's tokens {agree}/{total}", flush=True)
    check(errs[worst] <= SERVE_REL_L2,
          f"serving: kernel and plain logits within relative L2 {SERVE_REL_L2}")


def same_serving(a: dict, b: dict, vz: dict, sv: dict) -> None:
    """:func:`same_logits`; then on wave 0's prompts the first layer's
    attention outputs within LAYER_REL_L2, and on the card each planted
    fault breaks that first-layer check."""
    same_logits(a, b, vz, sv)
    tokens = sv["prompts"][:vz["batch"]]
    gap = first_layer_gap(sv, tokens)
    print(f"{sv['label']}: first layer, kernel vs plain attention output, largest relative "
          f"L2 over positions {gap:.6f} (limit {LAYER_REL_L2})", flush=True)
    check(gap <= LAYER_REL_L2,
          f"serving: first-layer attention outputs within relative L2 {LAYER_REL_L2}")
    if tokens.is_cuda:
        planted_faults(sv, tokens, b["logits"][0, 0])
    else:
        print(f"{sv['label']}: planted faults not run (the CPU has only the plain version)",
              flush=True)


def same_window_cache(full: dict, ring: dict, sv: dict) -> None:
    """The kernel runs with window_cache off and on (the second fed the
    first's tokens): every prefill's logits bit for bit (the same
    attention; only the cache's layout differs), every decode step's
    within SERVE_REL_L2 (the ring's decode sums the same keys' softmax in
    another order)."""
    vocab = sv["cfg"].vocab
    for key in full["logits"]:
        if key[1] == 0:
            check(torch.equal(full["logits"][key], ring["logits"][key]),
                  f"window_cache on and off: prefill logits of wave {key[0]} bit-identical")
    errs = {key: rel_l2(ring["logits"][key][:, :vocab], full["logits"][key][:, :vocab])
            for key in full["logits"] if key[1] > 0}
    worst = max(errs, key=errs.get)
    print(f"{sv['label']}: window_cache on vs off, kernel runs: prefill logits bit-identical; "
          f"decode logits relative L2 max {errs[worst]:.6f} at (wave, step) {worst}, mean "
          f"{sum(errs.values()) / len(errs):.6f} (limit {SERVE_REL_L2})", flush=True)
    check(errs[worst] <= SERVE_REL_L2,
          f"window_cache on vs off: decode logits within relative L2 {SERVE_REL_L2}")


def ring_decode_gap(sv: dict, prompts: torch.Tensor, fed: torch.Tensor, fault=None) -> float:
    """The first layer (a windowed one) alone: prefill ``prompts`` with
    window_cache off and on, then decode ``fed``'s tokens a step each;
    the largest relative L2 gap, per (request, head) and step, between
    the two runs' decode attention outputs, taken in float32 where
    ``decode_attention`` computes them.  ``fault`` (a wrapper of
    ``attention._cache_append``) is planted in the ring's run only."""
    cfg = dataclasses.replace(sv["cfg"], n_layers=1)
    check(lm.kind_at(cfg, 0) == "l" and 0 < cfg.sliding_window < prompts.shape[1],
          f"{sv['label']}: the first layer is windowed and the prompts pass its window")
    params = dict(sv["params"], layers=sv["params"]["layers"][:1])
    real_attn, real_append = lm.attn_mod.decode_attention, lm.attn_mod._cache_append
    outs = {}
    for ring in (False, True):
        seen = outs[ring] = []

        def tap(q, k, v, kv_len, lo=None):
            o = real_attn(q.float(), k, v, kv_len, lo=lo)    # its float32 result
            seen.append(o)
            return o.to(q.dtype)
        lm.attn_mod.decode_attention = tap
        if ring and fault is not None:
            lm.attn_mod._cache_append = fault(real_append)
        try:
            c = dataclasses.replace(cfg, window_cache=ring)
            cache, _ = lm.prefill(params, c, {"tokens": prompts},
                                  cache_len=prompts.shape[1] + fed.shape[1])
            check(cache["layers"][0]["k"].shape[2] == (cfg.sliding_window if ring else
                                                       prompts.shape[1] + fed.shape[1]),
                  f"{sv['label']}: window_cache {'on' if ring else 'off'} sizes the cache")
            for n in range(fed.shape[1]):
                _, cache = lm.decode_step(params, c, cache, fed[:, n:n + 1])
        finally:
            lm.attn_mod.decode_attention, lm.attn_mod._cache_append = real_attn, real_append
    return max(float((torch.linalg.vector_norm(a - b, dim=-1)
                      / torch.linalg.vector_norm(b, dim=-1)).max())
               for a, b in zip(outs[True], outs[False]))


def _ring_write_off_by_one(real):
    def fault(buf, x, pos):
        return real(buf, x, (pos + 1) % buf.shape[2])
    return fault


def _ring_write_skipped(real):
    def fault(buf, x, pos):
        return buf
    return fault


#: faults planted in the ring's decode append: what the ring check sees
RING_FAULTS = {"write index off by one (the oldest key of the window lost, one past it "
               "kept)": _ring_write_off_by_one,
               "append skipped (a stale slot: the newest key lost, one past the window "
               "kept)": _ring_write_skipped}


def ring_decode_check(sv: dict, vz: dict, tokens: dict) -> None:
    """The ring's decode held against the full cache's in the first
    windowed layer, on wave 0's prompts and served tokens, within
    RING_REL_L2; each planted ring fault must break it."""
    rows = list(range(min(vz["batch"], vz["requests"])))
    steps = min(4, vz["gen"])
    prompts = sv["prompts"][rows]
    fed = torch.tensor([tokens[i][:steps] for i in rows], device=prompts.device,
                       dtype=prompts.dtype)
    gap = ring_decode_gap(sv, prompts, fed)
    print(f"{sv['label']}: first layer's decode attention, ring vs full cache, largest "
          f"relative L2 per (request, head) over {steps} steps {gap:.3e} "
          f"(limit {RING_REL_L2})", flush=True)
    check(gap <= RING_REL_L2, f"window_cache: the ring's decode attention within relative L2 "
                              f"{RING_REL_L2} of the full cache's")
    for name, plant in RING_FAULTS.items():
        bad = ring_decode_gap(sv, prompts, fed, plant)
        print(f"{sv['label']}: planted ring fault '{name}': gap {bad:.3e} "
              f"(limit {RING_REL_L2})", flush=True)
        check(bad > RING_REL_L2, f"window_cache: the ring check catches '{name}'")


# --------------------------------------------------------------------------
# the MoE serving path: arctic-480b at full width through the exchange
# --------------------------------------------------------------------------

#: the MoE path's kernels: the exchange wire of every MoE layer's dispatch
#: and the bf16 prefill attention
MOE_WIRE = ("bin_offsets", "pack_rows", "place_rows")
MOE_KERNELS = MOE_WIRE + ("flash_attention",)
#: moe_apply itself (the serving path's tap stands in for it while it runs)
real_moe_apply = moe_mod.moe_apply
#: a router pick whose score margin (k-th minus (k+1)-th) is below this can
#: go another way in two bf16 runs that differ by the attention's rounding
FLIP_MARGIN = 1e-2


def moe_layers(cfg) -> int:
    """The layers that dispatch over the exchange (after ``first_k_dense``)."""
    return sum(lm._layer_is_moe(cfg, i) for i in range(cfg.n_layers))


def moe_wire_launches(cfg, passes: int) -> dict:
    """Wire kernel launches of ``passes`` forward passes on one rank: per
    MoE layer one binning pass and one pack per retry round, and
    place_rows for the two send maps of each of the two flows and for the
    reply."""
    calls = passes * moe_layers(cfg)
    return {"bin_offsets": calls, "pack_rows": calls * cfg.moe_dispatch_rounds,
            "place_rows": 6 * calls}


def moe_setup(mz: dict, dev, seed: int) -> dict:
    """The MoE model cut to ``layers`` layers (seeded init_params on the
    card, expert by expert) and serve.py's prompts."""
    cfg = get_config(mz["arch"])
    if mz["reduced"]:
        cfg = reduced(cfg)
    depth = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=mz["layers"])
    sync(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                   (mz["requests"], mz["prompt_len"]),
                                                   dtype=np.int32)
    n_params = _tree_sum(params)
    mo = cfg.moe
    attn = (f"MLA (q_lora {cfg.mla.q_lora_rank}, kv_lora {cfg.mla.kv_lora_rank}, nope "
            f"{cfg.mla.qk_nope_head_dim}, rope {cfg.mla.qk_rope_head_dim}, v "
            f"{cfg.mla.v_head_dim})" if cfg.mla else f"over {cfg.n_kv_heads}")
    dense = "dense residual" if mo.dense_residual else f"{mo.first_k_dense} dense layers"
    print(f"MoE model: {cfg.name}, {cfg.n_layers} of {depth} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads {attn}, {mo.n_experts} experts top-{mo.top_k} "
          f"(d_ff {mo.expert_d_ff}), {mo.shared_experts} shared, {dense} d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab} (padded {cfg.padded_vocab}), {n_params} parameters "
          f"({cfg.dtype}, router float32), init {init_s:.2f}s", flush=True)
    return dict(cfg=cfg, params=params, n_params=n_params, label=f"{cfg.name} serving",
                prompts=torch.from_numpy(prompts).to(dev))


def routed(p, x, cfg, impl: str) -> tuple:
    """One moe_apply call on one rank with its
    routing kept where the program makes it: ``router_topk``'s picks and
    scores, the token flow's owner-side ``src_pos`` (which copy each
    arrival is) and ``_bin_indices``' served mask.  Returns
    ``(moe_apply's outputs, those tensors)``; :func:`routing_of` reads
    them (after a timed run, so its work stays out of the timing)."""
    check(not cfg.moe_dedup_dispatch, "routed: one exchange row per (token, expert) pair")
    seen = {}
    real_topk, real_bins, real_view = moe_mod.router_topk, moe_mod._bin_indices, CommittedPlan.view

    def topk(*args):
        out = real_topk(*args)
        seen["idx"], seen["scores"] = out[1], out[3]
        return out

    def bins(*args):
        out = real_bins(*args)
        seen["ok"] = out[2]
        return out

    def view(self, handle):
        res = real_view(self, handle)
        if self._plan._flows[handle].op_name == "moe.dispatch":
            seen["src_pos"] = res.src_pos
        return res
    moe_mod.router_topk, moe_mod._bin_indices, CommittedPlan.view = topk, bins, view
    try:
        out = real_moe_apply(p, x, cfg, impl=impl)
    finally:
        moe_mod.router_topk, moe_mod._bin_indices, CommittedPlan.view = (
            real_topk, real_bins, real_view)
    return out, seen


def routing_of(seen: dict, cfg) -> tuple:
    """One call's routing from what :func:`routed` kept: (each token's
    top-k expert ids, sorted (B, T, K); the ids of the copies an expert
    served, sorted, E for a copy no expert served; each token's top-k
    score margin (B, T)).  A served arrival marks its copy (``src_pos``);
    the others write False past the end."""
    idx, k, ok = seen["idx"], cfg.moe.top_k, seen["ok"]
    n = idx.numel()
    served = torch.zeros(n + 1, dtype=torch.bool, device=idx.device).scatter_(
        0, torch.where(ok, seen["src_pos"], n).long(), ok)[:n]
    kept = torch.where(served.reshape(idx.shape), idx, cfg.moe.n_experts)
    s = seen["scores"].sort(dim=-1, descending=True).values
    return idx.sort(dim=-1).values, kept.sort(dim=-1).values, s[..., k - 1] - s[..., k]


def moe_serving_path(impl: str, mz: dict, mv: dict, forced=None) -> dict:
    """``serve`` over every request with moe_apply tapped: each call's
    routing by (wave, step, layer), and on wave 0's prefill and first
    decode step each call's input and outputs (for the exact check)."""
    logits, timings, routing, exact, pending = {}, {}, {}, {}, []

    def tap(params, x, cfg, layout=None, impl="auto"):
        check(layout is None, "the MoE serving path dispatches on one rank")
        out, rt = routed(params, x, cfg, impl)
        pending.append((params, x, out, rt))
        return out

    def keep(wave, step, lg):
        logits[wave, step] = lg
        for layer, (p, x, out, rt) in enumerate(pending):
            routing[wave, step, layer] = rt
            if wave == 0 and step <= 1:
                exact[wave, step, layer] = (p, x, out)
        pending.clear()
    moe_mod.moe_apply = tap
    t0 = time.perf_counter()
    try:
        tokens = serve(mv["params"], mv["cfg"], mv["prompts"], mz["batch"], mz["gen"], impl,
                       forced=forced, on_logits=keep, timings=timings)
    finally:
        moe_mod.moe_apply = real_moe_apply
    sync(mv["prompts"].device)
    serve_s = time.perf_counter() - t0
    routing = {key: routing_of(rt, mv["cfg"]) for key, rt in routing.items()}
    exact = {key: (*c, routing[key]) for key, c in exact.items()}
    return dict(tokens=tokens, logits=logits, timings=timings, routing=routing, exact=exact,
                impl=impl, serve_s=serve_s)


def check_moe_serving(r: dict, mz: dict, mv: dict) -> None:
    """Finite logits, one prefill and gen decode steps per wave, gen in-vocab
    tokens per request, one moe_apply call per layer and step."""
    cfg = mv["cfg"]
    n_waves = -(-mz["requests"] // mz["batch"])
    keys = [(w, s) for w in range(n_waves) for s in range(mz["gen"] + 1)]
    check(sorted(r["logits"]) == keys, "MoE serving: one prefill and gen decode steps per wave")
    check(sorted(r["routing"]) == [(w, s, i) for w, s in keys for i in range(moe_layers(cfg))],
          "MoE serving: one moe_apply call per layer and step")
    for key, lg in r["logits"].items():
        check(bool(torch.isfinite(lg).all()), f"MoE serving: finite logits at (wave, step) {key}")
    toks = r["tokens"]
    check(len(toks) == mz["requests"] and all(
        len(t) == mz["gen"] and all(0 <= x < cfg.vocab for x in t) for t in toks.values()),
        "MoE serving: gen in-vocab tokens per request")


def _swap_send_slots(real):
    """Fault: the send buffer's first and third row swapped after the pack
    (two token copies delivered to each other's experts)."""
    def fault(rows, bins, flow, offsets, valid, rnd, word_off, row_words, *rest):
        out = real(rows, bins, flow, offsets, valid, rnd, word_off, row_words, *rest)
        w = int(row_words[0])
        first = out[:w].clone()
        out[:w] = out[2 * w:3 * w]
        out[2 * w:3 * w] = first
        return out
    return fault


def moe_exact(mv: dict, call: tuple, plant=None) -> dict:
    """One captured moe_apply call of the kernel run (its input, outputs
    and routing) against moe_apply on its input with the plain versions:
    y, aux, expert_load, the drops and the routing (picks, served copies,
    margins, as :func:`routed` reads them from each run) bit for bit.
    ``plant`` wraps ``binning.pack_rows`` for a rerun of the call through
    the kernels, whose outputs then stand in for the captured ones."""
    p, x, (y, aux, st), routing = call
    cfg = mv["cfg"]
    if plant is not None:
        real = binning.pack_rows
        binning.pack_rows = plant(real)
        try:
            (y, aux, st), seen = routed(p, x, cfg, "auto")
        finally:
            binning.pack_rows = real
        routing = routing_of(seen, cfg)
    (y2, aux2, st2), seen = routed(p, x, cfg, "torch")
    routing2 = routing_of(seen, cfg)
    return dict(y=torch.equal(y, y2), aux=torch.equal(aux, aux2),
                load=torch.equal(st["expert_load"], st2["expert_load"]),
                dropped=torch.equal(st["dispatch_dropped"], st2["dispatch_dropped"]),
                routing=all(torch.equal(u, v) for u, v in zip(routing, routing2)),
                served=int(st["expert_load"].sum()), copies=x.shape[0] * x.shape[1] * cfg.moe.top_k)


def same_moe_serving(a: dict, b: dict, mz: dict, mv: dict) -> None:
    """Each MoE layer's call on wave 0's prefill and first decode step, as
    the kernel run made it, equals moe_apply on its input with the plain
    versions bit for bit (a planted wire fault must break that); the plain
    run, teacher-forced with the kernel run's tokens, gives every row's
    logits within SERVE_REL_L2 of the kernel run's, but for rows whose
    routing went another way at some layer and step so far in the wave: a
    top-k set flipped at a score margin below FLIP_MARGIN, in the row
    itself or (through the expert bins' capacity, which a decode step's
    copies share) in another row of the same call (counted and printed)."""
    cfg, vocab, batch = mv["cfg"], mv["cfg"].vocab, mz["batch"]
    for key, call in sorted(a["exact"].items()):
        got = moe_exact(mv, call)
        print(f"MoE serving: (wave, step, layer) {key}: kernel run vs plain moe_apply on its "
              f"input: " + json.dumps(got), flush=True)
        check(all(got[k] for k in ("y", "aux", "load", "dropped", "routing")),
              f"MoE serving: the call at {key} equals the plain moe_apply bit for bit")
    if mv["prompts"].is_cuda:
        key = (0, 0, 0)
        got = moe_exact(mv, a["exact"][key], plant=_swap_send_slots)
        print(f"MoE serving: planted fault (send slots 0 and 2 swapped after pack_rows) at "
              f"{key}: " + json.dumps(got), flush=True)
        check(not got["y"], "MoE serving: the exact check catches two swapped send slots")
    else:
        print("MoE serving: planted fault not run (the CPU has only the plain version)",
              flush=True)

    # per call: the smallest margin of a token whose top-k set flipped, and
    # the rows whose served experts differ
    apart = {}
    for key, (ids_a, kept_a, margin_a) in a["routing"].items():
        ids_b, kept_b, _ = b["routing"][key]
        flipped = (ids_a != ids_b).any(dim=-1)
        if bool(flipped.any()):
            rows_apart = ((ids_a != ids_b) | (kept_a != kept_b)).flatten(1).any(dim=1)
            apart[key] = (float(margin_a[flipped].min()), flipped.any(dim=1).tolist(),
                          rows_apart.tolist())
    flips, worst, rows = {}, 0.0, 0
    for (w, st), lg_a in sorted(a["logits"].items()):
        lg_b = b["logits"][w, st]
        for j in range(batch):
            if w * batch + j >= mz["requests"]:
                continue
            rows += 1
            err = rel_l2(lg_b[j, :vocab], lg_a[j, :vocab])
            if err <= SERVE_REL_L2:
                worst = max(worst, err)
                continue
            # the calls of this wave, at this step and before, routing row j apart
            causes = [(m, own[j]) for (w2, s2, _), (m, own, rows_apart) in apart.items()
                      if w2 == w and s2 <= st and rows_apart[j]]
            check(bool(causes) and min(m for m, _ in causes) < FLIP_MARGIN,
                  f"MoE serving: (wave, step) {(w, st)} row {j} logits relative L2 {err} "
                  f"above {SERVE_REL_L2} without a near-tie routing flip ({causes})")
            flips[w, st, j] = (round(err, 6), min(m for m, _ in causes),
                               any(o for _, o in causes))
    own = sum(f[2] for f in flips.values())
    print(f"MoE serving: kernel vs plain logits, {rows} rows: within relative L2 "
          f"{SERVE_REL_L2} {rows - len(flips)} (worst {worst:.6f}); outside it {len(flips)} "
          f"({own} after a flip of their own, {len(flips) - own} through a shared expert "
          f"bin), each after a routing flip at a margin below {FLIP_MARGIN}; calls with a "
          f"flip {len(apart)} of {len(a['routing'])}: (wave, step, row): [relative L2, "
          f"margin, own flip] " + json.dumps({str(k): v for k, v in sorted(flips.items())}),
          flush=True)
    a["flipped_rows"] = len(flips)


def moe_wire_phase(mz: dict, mv: dict, reps: int, dev) -> dict:
    """One prefill of wave 0 with the wire wrappers tapped: the largest
    bin_offsets, pack_rows and place_rows calls of the MoE path, each held
    bit for bit against its plain version and timed (CUDA events) beside
    its bound, with its device ms and launches by kernel on the card."""
    seen, originals = {}, []
    for name in MOE_WIRE:
        for attr in (name, name + "_plain"):   # the CPU (rehearsal) calls the plain ones
            real = getattr(binning, attr)
            originals.append((attr, real))

            def tap(*args, _name=name, _real=real):
                w = _work(_name, args)
                if w >= seen.get(_name, (-1,))[0]:
                    seen[_name] = (w, args)
                return _real(*args)
            setattr(binning, attr, tap)
    try:
        lm.prefill(mv["params"], mv["cfg"], {"tokens": mv["prompts"][:mz["batch"]]},
                   cache_len=mz["prompt_len"] + mz["gen"])
    finally:
        for attr, real in originals:
            setattr(binning, attr, real)
    check(set(seen) == set(MOE_WIRE), f"the MoE prefill reached {sorted(seen)}")
    rows = {}
    for name in MOE_WIRE:
        args = seen[name][1]
        fn, plain = getattr(binning, name), getattr(binning, name + "_plain")
        got = fn(*args)
        err = max_abs_err(got, plain(*args))
        check(err == 0, f"{name} at the MoE path's call: kernel equals its plain version")
        bytes_ms = bound_bytes(name, args, got) / HBM_BYTES_PER_S * 1e3
        ops_ms = bound_ops(name, args) / OPS_PER_S * 1e3
        row = dict(max_abs_err=err, ms=time_ms(lambda: fn(*args), reps, dev),
                   plain_ms=time_ms(lambda: plain(*args), max(1, reps // 5), dev),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   shape=[list(a.shape) for a in args if isinstance(a, torch.Tensor)])
        if name in WIRE_KERNELS:
            row["regime"] = wire_regime(name, args)
        if dev.type == "cuda":
            split = device_ms(lambda: fn(*args), reps)
            row.update(device_ms=sum(v["ms"] for v in split.values()),
                       launches=sum(v["launches"] for v in split.values()),
                       device_ms_by_kernel=short_names(split))
        rows[name] = row
        print(f"MoE wire {name}: " + json.dumps(row), flush=True)
        del got
    seen.clear()
    return rows


def moe_roles() -> dict:
    """Roles of the MoE path's device time: the (module, function) whose
    launches, its callees' included, each role takes."""
    return {"router": (moe_mod, "router_topk"), "bin_offsets": (binning, "bin_offsets"),
            "pack_rows": (binning, "pack_rows"), "place_rows": (binning, "place_rows"),
            "expert bmm": (moe_mod, "_expert_ffn"), "dense MLP": (layers_mod, "mlp"),
            "attention": (lm.attn_mod, "attention")}


#: kernel-name fragments of the library's GEMMs (cuBLAS, cuBLASLt, CUTLASS)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def role_split(fn, roles: dict, names=WIRE_DEVICE_NAMES, trace: dict | None = None,
               gemm_roles: dict | None = None) -> dict:
    """Device ms of each role of ``roles`` (role -> the (owner, attribute)
    whose calls, callees included, it takes; or a list of them) in one
    call of ``fn`` (torch.profiler).  Each role's calls run inside a
    ``record_function`` range, which the profiler also lays on the device
    as a span from the first to the last kernel the range launched; a
    kernel, memset or copy goes to the role of the innermost span holding
    it, or to "the rest" -- but a kernel named in ``names`` (the
    ctypes-launched ones, told apart by name) goes to its own role, and
    ``gemm_roles`` (role -> role) sends the GEMMs of a role to another.
    (Linking each kernel to its launching op instead, as ``FunctionEvent.kernels``
    does, linked some GEMMs of a zamba2-7b prefill wave to two ops: 1671
    ms by role of 1174 on the device.)  So the roles sum to the device
    time.  Given a ``trace`` dict, the same call's wall ms (host clock,
    synchronised on both sides, the profiler on) and device ms by name go
    into it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    originals = []
    for role, targets in roles.items():
        for mod, attr in (targets if isinstance(targets, list) else [targets]):
            real = getattr(mod, attr)
            originals.append((mod, attr, real))

            def wrapped(*args, _real=real, _role=role, **kwargs):
                with record_function("role:" + _role):
                    return _real(*args, **kwargs)
            setattr(mod, attr, wrapped)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, real in originals:
            setattr(mod, attr, real)
    gemm_roles = gemm_roles or {}
    out = {role: 0.0 for role in (*roles, *gemm_roles.values(),
                                  *dict.fromkeys(r for _, r in names), "the rest")}
    spans, device = [], {}
    on_device = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    for ev in on_device:
        if ev.name.startswith("role:"):
            spans.append((ev.time_range.start, ev.time_range.end, ev.name[5:]))
    for ev in on_device:
        if ev.name.startswith("role:"):
            continue
        start, end = ev.time_range.start, ev.time_range.end
        ms = (end - start) / 1e3
        device[ev.name] = device.get(ev.name, 0.0) + ms
        role = next((r for key, r in names if key in ev.name), None)
        if role is None:
            inside = [sp for sp in spans if sp[0] <= start and end <= sp[1]]
            role = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else "the rest"
            if role in gemm_roles and any(g in ev.name.lower() for g in GEMM_NAMES):
                role = gemm_roles[role]
        out[role] += ms
    out["total"] = sum(out.values())
    if trace is not None:
        trace.update(wall_ms=wall_ms, by_name=dict(sorted(device.items(), key=lambda kv: -kv[1])))
    return out


def moe_split(mz: dict, mv: dict) -> dict:
    """The device split by role of one prefill wave and one decode step
    through the kernels (after a warm wave and step)."""
    cfg, params = mv["cfg"], mv["params"]
    prompts = mv["prompts"][:mz["batch"]]
    state = {}

    def prefill():
        state["cache"], lg = lm.prefill(params, cfg, {"tokens": prompts},
                                        cache_len=mz["prompt_len"] + mz["gen"])
        state["tok"] = lg.argmax(-1)[:, None]

    def decode():
        lm.decode_step(params, cfg, dict(state["cache"]), state["tok"])
    prefill()
    decode()
    torch.cuda.synchronize()
    out = {"prefill wave": role_split(prefill, moe_roles()),
           "decode step": role_split(decode, moe_roles())}
    for what, split in out.items():
        print(f"MoE split {what} (device ms by role): "
              + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    return out


# --------------------------------------------------------------------------
# the deepseek-v3 serving path: MLA and top-8 MoE at full width
# --------------------------------------------------------------------------

def ds_setup(dz: dict, dev, seed: int) -> dict:
    """deepseek-v3 cut to ``layers`` layers, as :func:`moe_setup` cuts
    arctic, with the whole model's exact and active parameter counts
    (``lm.param_count_exact`` on the meta device) beside the cut model's."""
    full = get_config(dz["arch"])
    if dz["reduced"]:
        full = reduced(full)
    dv = moe_setup(dz, dev, seed)
    cut = dv["cfg"]
    counts = dict(model=lm.param_count_exact(full), model_active=lm.active_param_count_exact(full),
                  cut=lm.param_count_exact(cut), cut_active=lm.active_param_count_exact(cut))
    check(counts["cut"] == dv["n_params"], f"{cut.name}: the cut model's exact count "
                                           f"{counts['cut']} equals its tensors' {dv['n_params']}")
    print(f"{cut.name} parameters: whole model ({full.n_layers} layers) {counts['model']} exact, "
          f"{counts['model_active']} active a token; cut to {cut.n_layers} layers "
          f"{counts['cut']} exact, {counts['cut_active']} active; MTP head carried, unused "
          f"in serving", flush=True)
    dv["counts"] = counts
    return dv


def same_deepseek_serving(a: dict, b: dict, dz: dict, dv: dict) -> None:
    """The MoE path's checks (each MoE call on wave 0 bit for bit, the
    teacher-forced plain run's logits rows within SERVE_REL_L2 but for
    near-tie routing flips), then the first layer's prefill attention,
    kernel vs plain, within LAYER_REL_L2, and on the card each planted
    flash fault must break that check."""
    same_moe_serving(a, b, dz, dv)
    tokens = dv["prompts"][:dz["batch"]]
    gap = first_layer_gap(dv, tokens)
    print(f"{dv['label']}: first layer (MLA), kernel vs plain attention output, largest "
          f"relative L2 over positions {gap:.6f} (limit {LAYER_REL_L2})", flush=True)
    check(gap <= LAYER_REL_L2,
          f"{dv['label']}: first-layer attention outputs within relative L2 {LAYER_REL_L2}")
    if tokens.is_cuda:
        planted_faults(dv, tokens, b["logits"][0, 0])


def same_mla_absorb(off: dict, on: dict, dv: dict) -> None:
    """The kernel runs with mla_absorb off and on (the second fed the
    first's tokens): every prefill's logits bit for bit (the flag touches
    only decode), every decode step's within SERVE_REL_L2."""
    vocab = dv["cfg"].vocab
    for key in off["logits"]:
        if key[1] == 0:
            check(torch.equal(off["logits"][key], on["logits"][key]),
                  f"mla_absorb on and off: prefill logits of wave {key[0]} bit-identical")
    errs = {key: rel_l2(on["logits"][key][:, :vocab], off["logits"][key][:, :vocab])
            for key in off["logits"] if key[1] > 0}
    worst = max(errs, key=errs.get)
    print(f"{dv['label']}: mla_absorb on vs off, kernel runs: prefill logits bit-identical; "
          f"decode logits relative L2 max {errs[worst]:.6f} at (wave, step) {worst}, mean "
          f"{sum(errs.values()) / len(errs):.6f} (limit {SERVE_REL_L2})", flush=True)
    check(errs[worst] <= SERVE_REL_L2,
          f"mla_absorb on vs off: decode logits within relative L2 {SERVE_REL_L2}")


def _rope_dropped(real):
    """Fault: the absorbed score without its rope term."""
    def fault(params, cfg, q_nope, q_rope):
        q_lat, qr, w_uv, scale = real(params, cfg, q_nope, q_rope)
        return q_lat, torch.zeros_like(qr), w_uv, scale
    return fault


def _split_shifted(real):
    """Fault: ``w_ukv``'s W_uk / W_uv split read one column late (each head's
    W_uk from column 1, W_uv from column nope + 1 with a zero last column)."""
    def fault(params, cfg, q_nope, q_rope):
        m, h = cfg.mla, q_nope.shape[1]
        nope = m.qk_nope_head_dim
        w = params["w_ukv"].reshape(m.kv_lora_rank, h, nope + m.v_head_dim)
        shifted = torch.cat([w[:, :, 1:], torch.zeros_like(w[:, :, :1])], dim=-1)
        _, qr, _, scale = real(params, cfg, q_nope, q_rope)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, :, 0].float(),
                             shifted[:, :, :nope].float())
        return q_lat, qr, shifted[:, :, nope:].float(), scale
    return fault


#: faults planted in the absorbed decode: what the absorbed-vs-expanded check sees
MLA_FAULTS = {"the rope term dropped from the score": _rope_dropped,
              "the W_uk / W_uv split shifted by one column": _split_shifted}


def mla_decode_forms(dv: dict, prompts: torch.Tensor, fed: torch.Tensor, fault=None) -> dict:
    """The first layer (MLA) alone: prefill ``prompts``, then decode
    ``fed``'s tokens a step each, and at each step run the layer's decode
    twice on the same cache contents (the step writes the same slot each
    time): expanded (``mla_absorb`` off) and absorbed, each tapped for its
    float32 attention output (B, H, v) before ``wo``.  ``fault`` wraps
    ``attention._absorbed`` in the absorbed run.  Returns the largest
    relative L2 gap between the two over (request, head) and step."""
    cfg = dataclasses.replace(dv["cfg"], n_layers=1)
    params = dict(dv["params"], layers=dv["params"]["layers"][:1])
    att = lm.attn_mod
    h, vdim = cfg.n_heads, cfg.mla.v_head_dim
    forms = {"expanded": dict(mla_absorb=False), "absorbed": dict(mla_absorb=True)}
    outs = {f: [] for f in forms}
    real = {n: getattr(att, n) for n in ("decode_attention", "_mla_absorbed_decode",
                                         "_absorbed")}

    def tap(form, name):
        def fn(*args, **kwargs):
            if name == "decode_attention":
                q, k, v, kv_len = args
                o = real[name](q.float(), k, v, kv_len)              # (B, H, 1, v) float32
                outs[form].append(o[:, :, 0])
                return o.to(q.dtype)
            params_, cfg_, q_nope, q_rope, c_kv, k_rope, pos = args
            o = real[name](params_, cfg_, q_nope.float(), q_rope.float(), c_kv, k_rope, pos)
            outs[form].append(o.reshape(o.shape[0], h, vdim))
            return o.to(q_nope.dtype)
        return fn

    cache, _ = lm.prefill(params, cfg, {"tokens": prompts},
                          cache_len=prompts.shape[1] + fed.shape[1])
    try:
        for n in range(fed.shape[1]):
            for form, over in forms.items():
                att.decode_attention = tap(form, "decode_attention")
                att._mla_absorbed_decode = tap(form, "_mla_absorbed_decode")
                att._absorbed = (fault(real["_absorbed"]) if fault is not None
                                 and form == "absorbed" else real["_absorbed"])
                c = dataclasses.replace(cfg, **over)
                _, nxt = lm.decode_step(params, c, dict(cache), fed[:, n:n + 1])
            cache = nxt
    finally:
        for name, fn in real.items():
            setattr(att, name, fn)
    check(all(len(v) == fed.shape[1] for v in outs.values()),
          f"{dv['label']}: each decode form ran once a step {[len(v) for v in outs.values()]}")

    return max(float((torch.linalg.vector_norm(x - y, dim=-1)
                      / torch.linalg.vector_norm(y, dim=-1)).max())
               for x, y in zip(outs["expanded"], outs["absorbed"]))


def mla_decode_check(dv: dict, dz: dict, tokens: dict) -> dict:
    """The first layer's float32 decode attention two ways on wave 0's
    prompts and served tokens for 4 steps: the expanded form (K and V
    rounded to bf16 by the expansion) within LAYER_REL_L2 of the absorbed
    one; each planted fault in the absorbed form must break that check.
    (``mla_cp_decode`` selects the absorbed form on one rank.)"""
    rows = list(range(min(dz["batch"], dz["requests"])))
    steps = min(4, dz["gen"])
    prompts = dv["prompts"][rows]
    fed = torch.tensor([tokens[i][:steps] for i in rows], device=prompts.device,
                       dtype=prompts.dtype)
    gap = mla_decode_forms(dv, prompts, fed)
    print(f"{dv['label']}: first layer's decode attention (float32, per (request, head), "
          f"{steps} steps), largest relative L2: absorbed vs expanded {gap:.3e} "
          f"(limit {LAYER_REL_L2})", flush=True)
    check(gap <= LAYER_REL_L2,
          f"MLA decode: the expanded form within {LAYER_REL_L2} of the absorbed one")
    faults = {}
    for name, plant in MLA_FAULTS.items():
        bad = mla_decode_forms(dv, prompts, fed, plant)
        faults[name] = bad
        print(f"{dv['label']}: planted MLA fault '{name}': absorbed vs expanded {bad:.3e} "
              f"(limit {LAYER_REL_L2})", flush=True)
        check(bad > LAYER_REL_L2, f"MLA decode: the absorbed-vs-expanded check catches '{name}'")
    return dict(gap=gap, faults=faults)


def ds_roles() -> dict:
    """Roles of the deepseek path's device time (see :func:`role_split`);
    ``shared expert`` is ``L.mlp`` as ``models/moe.py`` calls it (the
    caller installs :func:`_moe_layers_view`), ``dense MLP`` as the dense
    layers call it."""
    att = lm.attn_mod
    return {"MLA projections": (att, "mla_attention"), "K/V expansion": (att, "_expand_kv"),
            "flash": (ops, "flash_attention"),
            "decode attention": [(att, "decode_attention"), (att, "_mla_absorbed_decode")],
            "router": (moe_mod, "router_topk"), "bin_offsets": (binning, "bin_offsets"),
            "pack_rows": (binning, "pack_rows"), "place_rows": (binning, "place_rows"),
            "expert bmm": (moe_mod, "_expert_ffn"), "shared expert": (moe_mod.L, "mlp"),
            "dense MLP": (layers_mod, "mlp")}


def _moe_layers_view():
    """A copy of the layers module for ``models/moe.py`` alone, so that its
    ``L.mlp`` calls (the shared expert) take a role of their own."""
    import types
    view = types.ModuleType("layers_for_moe")
    view.__dict__.update({k: v for k, v in vars(layers_mod).items() if not k.startswith("__")})
    return view


#: the flash kernels as the profiler names them, beside the wire's
DS_DEVICE_NAMES = WIRE_DEVICE_NAMES + (("flash_fwd", "flash"),)


def ds_split(dz: dict, dv: dict, absorb: bool) -> dict:
    """The device split by role of one prefill wave and one decode step
    through the kernels (after a warm wave and step), with ``mla_absorb``
    as given."""
    cfg = dataclasses.replace(dv["cfg"], mla_absorb=absorb)
    params, prompts = dv["params"], dv["prompts"][:dz["batch"]]
    state = {}

    def prefill():
        state["cache"], lg = lm.prefill(params, cfg, {"tokens": prompts},
                                        cache_len=dz["prompt_len"] + dz["gen"])
        state["tok"] = lg.argmax(-1)[:, None]

    def decode():
        lm.decode_step(params, cfg, dict(state["cache"]), state["tok"])
    real_l = moe_mod.L
    moe_mod.L = _moe_layers_view()
    try:
        prefill()
        decode()
        torch.cuda.synchronize()
        out = {"prefill wave": role_split(prefill, ds_roles(), names=DS_DEVICE_NAMES)}
        out["decode step"] = role_split(decode, ds_roles(), names=DS_DEVICE_NAMES)
    finally:
        moe_mod.L = real_l
    for what, split in out.items():
        print(f"deepseek split, mla_absorb {'on' if absorb else 'off'}, {what} (device ms by "
              f"role): " + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    return out


# --------------------------------------------------------------------------
# the recurrent serving cells: zamba2-7b and rwkv6-1.6b at full width and depth
# --------------------------------------------------------------------------

def flash_calls(cfg) -> int:
    """The flash launches of one prefill: one per attention layer (``g``,
    ``l``, ``a``), and for an encoder-decoder one per encoder layer and one
    per decoder cross-attention (``g``, ``l``)."""
    kinds = [lm.kind_at(cfg, i) for i in range(cfg.n_layers)]
    cross = sum(k in "gl" for k in kinds) if cfg.encoder_layers else 0
    return sum(k in "gla" for k in kinds) + cfg.encoder_layers + cross


def serving_launches(cfg, n_waves: int, gen: int, prompt_len: int, nm: int = 1) -> dict:
    """The kernel launches one ``serve`` run makes without MoE layers (on
    each of ``nm`` model ranks): the flash route of the model's dtype
    ``flash_calls`` times a wave, each mixer's scan once per ``m`` or ``r``
    layer and call (a prefill of ``prompt_len`` steps and ``gen`` decode
    steps a wave); Mamba2's by the route each call's shape (a rank's
    heads) picks."""
    kinds = [lm.kind_at(cfg, i) for i in range(cfg.n_layers)]
    route = "flash_attention_f32" if cfg.dtype == "float32" else "flash_attention"
    per_call = {route: flash_calls(cfg) * n_waves,
                "mamba_scan": 0, "mamba_scan_seq": 0,
                "rwkv_scan": kinds.count("r") * n_waves * (gen + 1)}
    if "m" in kinds:
        _inner, nh, head = ssm_mod.mamba_dims(cfg)
        for t, calls in ((prompt_len, 1), (1, gen)):
            chunked = ssm_scan.mamba_route(t, nh // nm, head, cfg.ssm.d_state) > 0
            per_call["mamba_scan" if chunked else "mamba_scan_seq"] += \
                kinds.count("m") * n_waves * calls
    return {name: n for name, n in per_call.items() if n}


def ssm_setup(cz: dict, dev, seed: int) -> dict:
    """:func:`serving_setup`, with the exact parameter count (on the meta
    device) held against the tensors', and the cache's bytes for the cell's
    slots: the recurrent state (``m``, ``r`` layers) and the K/V (``a``)."""
    cv = serving_setup(cz, dev, seed)
    cfg = cv["cfg"]
    exact = lm.param_count_exact(cfg)
    check(exact == cv["n_params"], f"{cfg.name}: exact count {exact} equals its tensors' "
                                   f"{cv['n_params']}")
    cache = lm.cache_init(cfg, cz["batch"], cz["prompt_len"] + cz["gen"], "meta")
    kinds = [lm.kind_at(cfg, i) for i in range(cfg.n_layers)]
    cv["state_bytes"] = sum(_tree_bytes(c) for c, k in zip(cache["layers"], kinds) if k in "mr")
    cv["kv_bytes"] = sum(_tree_bytes(c) for c, k in zip(cache["layers"], kinds) if k in "gla")
    print(f"{cfg.name}: layers {''.join(kinds)}, {exact} parameters exact "
          f"({_tree_bytes(cv['params'])} bytes); cache for {cz['batch']} slots: recurrent "
          f"state {cv['state_bytes']} bytes, K/V {cv['kv_bytes']} bytes", flush=True)
    return cv


def scan_calls(sv: dict, vz: dict) -> tuple[str, dict]:
    """The first mixer layer's scan calls through the kernels on wave 0's
    prompts, tapped at ``ops`` as ``models/ssm.py`` makes them (the
    operands themselves, strided views included): its prefill call, the
    largest a cell makes, and its first decode call.  Returns the scan's
    name and ``{"prefill": args, "decode": args}``."""
    cfg, params = sv["cfg"], sv["params"]
    name = "mamba_scan" if "m" in cfg.layer_pattern else "rwkv_scan"
    real, seen = getattr(ops, name), []

    def tap(*args, impl="auto"):
        seen.append(args)
        return real(*args, impl=impl)
    setattr(ops, name, tap)
    try:
        cache, logits = lm.prefill(params, cfg, {"tokens": sv["prompts"][:vz["batch"]]},
                                   cache_len=vz["prompt_len"] + vz["gen"])
        n_prefill = len(seen)
        lm.decode_step(params, cfg, cache, logits.argmax(-1)[:, None])
    finally:
        setattr(ops, name, real)
    return name, {"prefill": seen[0], "decode": seen[n_prefill]}


#: relative L2 gap allowed between a scan's kernel and plain outputs, and
#: between their final states, on the same float32 operands: the sequential
#: routes round each state update as the plain steps do (their states are
#: also held bit for bit) and sum over s or k in another order (a few ulps
#: of each); mamba's chunked route takes its products in 3xTF32 (about
#: 2**-20 of each) and its decays as differences of chunk-local running sums
SCAN_REL_L2 = 1e-5
#: a planted fault must move a tight check past this many times its limit
FAULT_FACTOR = 100


def _mamba_decay_after_update(real):
    def fault(x, dt, b, c, a, h0):       # h = decay (h + b x dt): x scaled by the decay
        return real(x * torch.exp(a[None, None] * dt)[..., None], dt, b, c, a, h0)
    return fault


def _rwkv_decay_after_update(real):
    def fault(r, k, v, w, u, s0):         # s = w (s + k v): k scaled by w, the bonus's too
        return real(r, w * k, v, w, u, s0)
    return fault


def _rwkv_bonus_dropped(real):
    def fault(r, k, v, w, u, s0):
        return real(r, k, v, w, torch.zeros_like(u), s0)
    return fault


#: faults planted around each scan's wrapper: what the first-mixer check sees
SCAN_FAULTS = {
    "mamba_scan": {"decay applied after the update": _mamba_decay_after_update},
    "rwkv_scan": {"decay applied after the update (the bonus reads the decayed key)":
                  _rwkv_decay_after_update, "bonus u dropped": _rwkv_bonus_dropped}}


def scan_cuda_core_ms(name: str, args: tuple) -> float:
    """The sequential form's operations at the float32 rate outside the
    tensor cores, as few as the function needs: per state element and
    step, mamba: h * decay, b * xdt, their sum, c h accumulated = 5; rwkv:
    k v, r s accumulated, w s, its sum = 5, and per step and k the bonus
    v sum_k r u k (r u k accumulated, then v times it added) = 5."""
    if name == "rwkv_scan":
        nb, t, nh, k = args[0].shape
        ops_n = nb * t * nh * (5 * k * k + 5 * k)
    else:
        nb, t, nh, p = args[0].shape
        ops_n = 5 * nb * t * nh * args[2].shape[-1] * p
    return ops_n / OPS_PER_S * 1e3


def ssd_tf32_ms(args: tuple) -> float:
    """The chunked (SSD) form's products in three TF32 passes at the
    tensor-core rate: per (batch, head), M X over the kept (i, j <= i) pairs
    of each chunk of L steps, C h and B^T (W X) over every (step, s), and
    per batch row G = C B^T over the kept pairs (shared by the heads)."""
    nb, t, nh, p = args[0].shape
    s, chunk = args[2].shape[-1], ssm_scan.SSD_CHUNK
    pairs = sum(n * (n + 1) // 2 for n in [chunk] * (t // chunk) + [t % chunk])
    flops = 2 * nb * (nh * p * (pairs + 2 * t * s) + pairs * s)
    return 3 * flops / TF32_OPS_PER_S * 1e3


def scan_kernel(name: str, args: tuple) -> str:
    """The counted kernel a scan call on these operands launches: Mamba2's
    route by shape (``ssm_scan.mamba_route``), RWKV's one kernel."""
    if name == "rwkv_scan":
        return name
    _nb, t, nh, p = args[0].shape
    return "mamba_scan" if ssm_scan.mamba_route(t, nh, p, args[2].shape[-1]) else \
        "mamba_scan_seq"


#: the route each scan kernel runs
SCAN_ROUTES = {"mamba_scan": "chunked", "mamba_scan_seq": "sequential", "rwkv_scan": "sequential"}


def scan_bound(name: str, args: tuple, outs: tuple, route: str) -> tuple[float, str]:
    """(bound ms, what bounds it): every operand read once and both outputs
    written once, against the operations of the form the route runs: the
    chunked mamba route's products on the tensor cores (ssd_tf32_ms), the
    sequential routes' on the CUDA cores (scan_cuda_core_ms)."""
    ops_ms = ssd_tf32_ms(args) if route == "chunked" else scan_cuda_core_ms(name, args)
    bytes_ms = _nbytes(*args, *outs) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def scan_check(name: str, calls: dict, reps: int, dev) -> dict:
    """The first mixer layer's scan, kernel against plain on the same
    operands at the prefill and the decode call: on the card, each call
    launches the kernel its shape picks (scan_kernel) once and no other;
    the output and the final state each within SCAN_REL_L2 relative L2
    (and whether the states are bit-identical); kernel, plain and bound
    times.  On the prefill call each planted fault of SCAN_FAULTS must
    break that check by FAULT_FACTOR.  Returns the rows by the kernel each
    call launched (the kernels line's; the prefill call's where both
    launch one kernel)."""
    kern = getattr(ssm_scan, name)
    plain = getattr(ssm_scan, name + "_plain")
    rows = {}
    for label, args in calls.items():
        kname = scan_kernel(name, args)
        before = build.launch_counts()
        got, want = kern(*args), plain(*args)
        sync(dev)
        ran = {n: c - before[n] for n, c in build.launch_counts().items() if c != before[n]}
        if dev.type == "cuda":
            check(ran == {kname: 1}, f"{name} {label} call: one launch of {kname}, got {ran}")
        route = SCAN_ROUTES[kname] if dev.type == "cuda" else "plain"
        gaps = [rel_l2(g, w) for g, w in zip(got, want)]
        bound_ms, bound_by = scan_bound(name, args, got, route)
        row = dict(
            scan_route=route,
            max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
            rel_l2=dict(output=gaps[0], state=gaps[1]),
            state_equal=bool(torch.equal(got[1], want[1])),
            ms=time_ms(lambda: kern(*args), reps, dev),
            plain_ms=time_ms(lambda: plain(*args), max(1, reps // 5), dev),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            cuda_core_ms=scan_cuda_core_ms(name, args),
            host_us=host_us(lambda: kern(*args)) if dev.type == "cuda" else None,
            shape=[list(a.shape) for a in args])
        rows.setdefault(kname, row)
        print(f"kernel {kname} {label}: " + json.dumps(row), flush=True)
        check(max(gaps) <= SCAN_REL_L2, f"{name} {label} call: output and final state within "
                                        f"relative L2 {SCAN_REL_L2} of the plain version: {gaps}")
        if route == "sequential":
            check(row["state_equal"], f"{name} {label} call ({kname}): the final state "
                                      f"bit-identical to the plain version's")
    args, want = calls["prefill"], plain(*calls["prefill"])
    for fault, plant in SCAN_FAULTS[name].items():
        bad = max(rel_l2(g, w) for g, w in zip(plant(kern)(*args), want))
        print(f"{name}: planted fault '{fault}': output / state gap {bad:.3e} "
              f"(limit {SCAN_REL_L2:g})", flush=True)
        check(bad > FAULT_FACTOR * SCAN_REL_L2, f"{name}: the first-mixer check catches "
                                                f"'{fault}' by {FAULT_FACTOR}x")
    return rows


def _conv_state_zeroed(real):
    def fault(params, x, cfg, state=None, impl="auto", bk=None):
        if state is not None and x.shape[1] == 1:
            state = dict(state, conv=torch.zeros_like(state["conv"]))
        return real(params, x, cfg, state, impl=impl, bk=bk)
    return fault


def _prev_dropped(real):
    def fault(params, x, cfg, state=None, impl="auto", bk=None):
        if state is not None and x.shape[1] == 1:
            state = dict(state, prev=torch.zeros_like(state["prev"]))
        return real(params, x, cfg, state, impl=impl, bk=bk)
    return fault


#: faults planted at decode in each mixer (models/ssm.py): what the state-carry
#: check sees
STATE_FAULTS = {"m": ("mamba_apply", "conv state zeroed at decode", _conv_state_zeroed),
                "r": ("rwkv_apply", "prev dropped at decode (time mix)", _prev_dropped)}


def state_carry_gap(params, cfg, prompts: torch.Tensor, fed: torch.Tensor, embeds=None,
                    plant=None) -> float:
    """Relative L2 gap between the logits of a prefill of ``prompts`` (P
    tokens) and a decode step of ``fed`` (B, 1), and the last row's of a
    prefill of the P + 1 tokens, each prefill with the rows' frontend
    ``embeds``: what the cache carries (``conv``, ``ssd``, ``s``, ``prev``,
    ``cm_prev``, K/V, an encoder-decoder's cross K/V) must give the same
    step.  ``plant`` = (owner, function name, wrapper) is in place for the
    prefill and decode step."""
    embeds = embeds or {}
    full = torch.cat([prompts, fed.to(prompts.dtype)], dim=1)
    cache_len = n_patches(embeds) + full.shape[1]
    _, want = lm.prefill(params, cfg, {"tokens": full, **embeds}, cache_len=cache_len)
    with planted(plant):
        cache, _ = lm.prefill(params, cfg, {"tokens": prompts, **embeds}, cache_len=cache_len)
        check(cache["pos"] == cache_len - 1, f"{cfg.name}: pos {cache['pos']} after a prefill of "
                                             f"{n_patches(embeds)} patches and "
                                             f"{prompts.shape[1]} tokens")
        got, _ = lm.decode_step(params, cfg, cache, fed)
    return rel_l2(got[:, :cfg.vocab], want[:, :cfg.vocab])


def carry_check(label: str, r: dict, limit: float, faults: dict, factor: float) -> None:
    """:func:`state_carry_gap` on wave 0's prompts (and embeddings) and
    first served tokens within ``limit``; each planted fault of ``faults``
    (name -> (owner, function name, wrapper)) must break it by ``factor``."""
    cfg, batch = r["cfg"], r["batch"]
    prompts, embeds = r["prompts"][:batch], rows_of(r["embeds"], slice(0, batch))
    fed = torch.tensor([[r["tokens"][i][0]] for i in range(batch)], device=prompts.device)
    gap = state_carry_gap(r["params"], cfg, prompts, fed, embeds)
    print(f"{cfg.name}: {label}, prefill of {prompts.shape[1]} + a decode step vs a "
          f"prefill of {prompts.shape[1] + 1}, logits relative L2 {gap:.3e} (limit {limit:g})",
          flush=True)
    check(gap <= limit, f"{cfg.name}: {label} within relative L2 {limit:g}")
    for fault, plant in faults.items():
        bad = state_carry_gap(r["params"], cfg, prompts, fed, embeds, plant=plant)
        print(f"{cfg.name}: planted fault '{fault}': {label} gap {bad:.3e} (limit {limit:g})",
              flush=True)
        check(bad > factor * limit, f"{cfg.name}: the {label} check catches '{fault}' by "
                                    f"{factor:g}x")


def state_carry_check(r: dict, limit: float) -> None:
    """:func:`carry_check` of the state carry; each planted fault of a mixer
    kind the model has (STATE_FAULTS) must break it by FAULT_FACTOR."""
    faults = {fault: (ssm_mod, fn, plant) for kind, (fn, fault, plant) in STATE_FAULTS.items()
              if kind in r["cfg"].layer_pattern}
    carry_check("state carry", r, limit, faults, FAULT_FACTOR)


def ssm_roles() -> dict:
    """Roles of the recurrent cells' device time (see :func:`role_split`):
    each mixer's glue (GEMMs inside it go to "in/out projections", its scan
    kernel by name), the shared attention (its flash kernel by name), the
    MLP, RWKV's channel mix; GEMMs outside every role are the head's."""
    return {"mixer glue": [(ssm_mod, "mamba_apply"), (ssm_mod, "rwkv_apply")],
            "shared attention": (lm.attn_mod, "attention"), "MLP": (layers_mod, "mlp"),
            "channel mix": (ssm_mod, "rwkv_channel_mix")}


#: the recurrent cells' ctypes-launched kernels as the profiler names them
SSM_DEVICE_NAMES = (("mamba_scan_kernel", "scan kernel"), ("mamba_ssd_kernel", "scan kernel"),
                    ("rwkv_scan_kernel", "scan kernel"),
                    ("flash_fwd", "flash"))
#: GEMMs inside a role, by the role they go to instead
SSM_GEMM_ROLES = {"mixer glue": "in/out projections", "the rest": "head"}


def ssm_split(cz: dict, cv: dict) -> dict:
    """The device split by role of one prefill wave and one decode step
    through the kernels (after a warm wave and step)."""
    cfg, params = cv["cfg"], cv["params"]
    prompts = cv["prompts"][:cz["batch"]]
    state = {}

    def prefill():
        state["cache"], lg = lm.prefill(params, cfg, {"tokens": prompts},
                                        cache_len=cz["prompt_len"] + cz["gen"])
        state["tok"] = lg.argmax(-1)[:, None]

    def decode():
        lm.decode_step(params, cfg, state["cache"], state["tok"])
    prefill()
    decode()
    torch.cuda.synchronize()
    out = {}
    for what, fn in (("prefill wave", prefill), ("decode step", decode)):
        trace = {}
        out[what] = split = role_split(fn, ssm_roles(), names=SSM_DEVICE_NAMES, trace=trace,
                                       gemm_roles=SSM_GEMM_ROLES)
        print(f"{cfg.name} split {what} (device ms by role; wall {trace['wall_ms']:.2f} ms, "
              f"device {sum(trace['by_name'].values()):.2f} ms): "
              + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
        print(f"{cfg.name} split {what}: device ms by kernel "
              + json.dumps(short_names({k: dict(ms=v) for k, v in trace["by_name"].items()})),
              flush=True)
    return out


# --------------------------------------------------------------------------
# the frontend cells: seamless-m4t-medium (encoder-decoder, frames) and
# internvl2-76b (patches before the text)
# --------------------------------------------------------------------------

def frontend_batch(cfg, requests: int, seq: int, dev, seed: int) -> dict:
    """A prefill batch of ``seq`` positions for ``requests`` requests, drawn
    from ``seed`` as ``data.tokens.synth_batch`` draws it: ``tokens`` and
    the frontend's float32 ``patch_embeds`` (``frontend_len`` of the
    positions) or ``src_embeds`` (``max(seq // 4, 8)`` source frames)."""
    return synth_batch(cfg, ShapeSpec("serve", seq, requests, "prefill"),
                       np.random.default_rng(seed), device=dev)


def frontend_setup(fz: dict, dev, seed: int) -> dict:
    """The model (cut to ``layers`` decoder layers if given; seeded
    init_params on the card), its exact parameter counts (the whole
    model's beside the cut's) and the cell's prompts and embeddings."""
    cfg = get_config(fz["arch"])
    if fz["reduced"]:
        cfg = reduced(cfg)
    whole = cfg
    if fz["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=fz["layers"])
    sync(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = _tree_sum(params)
    exact = lm.param_count_exact(cfg)
    check(exact == n_params, f"{cfg.name}: exact count {exact} equals its tensors' {n_params}")
    batch = frontend_batch(cfg, fz["requests"], fz["seq"], dev, seed)
    prompts = batch.pop("tokens")
    print(f"frontend model: {cfg.name}, {cfg.encoder_layers} encoder and {cfg.n_layers} of "
          f"{whole.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.activation}), vocab "
          f"{cfg.vocab} (padded {cfg.padded_vocab}), {n_params} parameters exact "
          f"({_tree_bytes(params)} bytes, {cfg.dtype}; the whole model "
          f"{lm.param_count_exact(whole)}), init {init_s:.2f}s; prompts "
          f"{tuple(prompts.shape)}, "
          + ", ".join(f"{k} {tuple(e.shape)}" for k, e in batch.items()), flush=True)
    return dict(cfg=cfg, params=params, n_params=n_params, label=f"{cfg.name} serving",
                prompts=prompts, embeds=batch)


def attention_calls(params, cfg, tokens: torch.Tensor, embeds: dict) -> dict:
    """``lm.forward`` of ``tokens`` and ``embeds`` through the kernels (no
    cache: the prefill's attention), its attention calls tapped where
    ``lm`` makes them; the first of each role, as (args, kwargs):
    ``encoder`` (non-causal self-attention), ``cross`` (``kv_source``
    given) and ``self`` (the decoder's causal one)."""
    real, seen = lm.attn_mod.attention, {}

    def tap(*args, **kwargs):
        role = ("cross" if kwargs.get("kv_source") is not None else
                "self" if kwargs.get("causal", True) else "encoder")
        seen.setdefault(role, (args, kwargs))
        return real(*args, **kwargs)
    lm.attn_mod.attention = tap
    try:
        lm.forward(params, cfg, tokens, impl="auto", **embeds)
    finally:
        lm.attn_mod.attention = real
    return seen


def call_gap(call: tuple, plant=None) -> float:
    """One captured attention call rerun on its own inputs through the
    kernel and the plain version: the largest per-position relative L2 gap
    of the outputs.  ``plant`` (see :func:`planted`) is in place for the
    kernel run only."""
    args, kwargs = call
    with planted(plant):
        got = lm.attn_mod.attention(*args, **dict(kwargs, cache=None, impl="auto"))[0]
    want = lm.attn_mod.attention(*args, **dict(kwargs, cache=None, impl="torch"))[0]
    return position_gap(got, want)


def _causal_encoder(real):
    def fault(q, k, v, causal=True, window=0, **kw):
        return real(q, k, v, causal=causal or q.shape[2] == k.shape[2], window=window, **kw)
    return fault


def _cross_kv_unwritten(real):
    def fault(params, x, cfg, *, cache=None, kv_source=None, **kw):
        if kv_source is None or cache is None:
            return real(params, x, cfg, cache=cache, kv_source=kv_source, **kw)
        out, _ = real(params, x, cfg, kv_source=kv_source, **kw)
        return out, cache          # xk/xv stay as cache_init made them: zero
    return fault


def _cross_rotary(real):
    def fault(params, x, cfg, *, positions, causal=True, window=0, cache=None,
              cache_len=None, kv_source=None, impl="auto", bk=None):
        if kv_source is None:
            return real(params, x, cfg, positions=positions, causal=causal, window=window,
                        cache=cache, cache_len=cache_len, impl=impl, bk=bk)
        b, t, _ = x.shape
        s, hd = kv_source.shape[1], cfg.head_dim
        src_pos = torch.arange(s, device=x.device)[None, None]
        q = layers_mod.rotary((x @ params["wq"]).reshape(b, t, -1, hd).transpose(1, 2),
                              positions[:, None], cfg.rope_theta)
        k = layers_mod.rotary((kv_source @ params["wk"]).reshape(b, s, -1, hd).transpose(1, 2),
                              src_pos, cfg.rope_theta)
        v = (kv_source @ params["wv"]).reshape(b, s, -1, hd).transpose(1, 2)
        if cache is not None:
            cache["k"][:, :, :s], cache["v"][:, :, :s] = k, v
        out = ops.flash_attention(q, k, v, causal=False, impl=impl)
        return out.transpose(1, 2).reshape(b, t, -1) @ params["wo"], cache
    return fault


def _positions_restart(real):
    def fault(params, x, cfg, *, positions, **kw):
        p = cfg.frontend_len
        if positions.shape[1] > p:      # a prefill over the patches and the text
            positions = torch.cat([positions[:, :p], positions[:, p:] - p], dim=1)
        return real(params, x, cfg, positions=positions, **kw)
    return fault


#: faults planted in the model around the attention: what the decode checks see
CROSS_FAULTS = {"cross K/V left zero at prefill (the JAX package's behaviour)":
                (lm.attn_mod, "attention", _cross_kv_unwritten),
                "rotary applied to the cross-attention's q and k":
                (lm.attn_mod, "attention", _cross_rotary)}
PATCH_FAULTS = {"positions restarted at the first text token":
                (lm.attn_mod, "attention", _positions_restart)}


def decode_row_gap(fv: dict, prompts: torch.Tensor, fed: torch.Tensor, embeds: dict,
                   plant=None) -> float:
    """The first decoder layer's attention at a decode step (an
    encoder-decoder's cross-attention over the cached ``xk``/``xv``, else
    the self-attention over the cached K/V) against the same call in a
    prefill of ``prompts`` + ``fed`` through the kernel, on the same input
    row (that prefill's last): the largest relative L2 gap over rows.  The
    model is cut to that layer (an encoder-decoder keeps its encoder);
    ``plant`` = (owner, function name, wrapper) is in place for the prefill
    of ``prompts`` that writes the cache."""
    cfg = dataclasses.replace(fv["cfg"], n_layers=1)
    params = dict(fv["params"], layers=fv["params"]["layers"][:1])
    real = lm.attn_mod.attention
    full = torch.cat([prompts, fed.to(prompts.dtype)], dim=1)
    args, kwargs = attention_calls(params, cfg, full, embeds)[
        "cross" if cfg.encoder_layers else "self"]
    want, x = real(*args, **kwargs)[0][:, -1:], args[1][:, -1:]
    with planted(plant):
        cache, _ = lm.prefill(params, cfg, {"tokens": prompts, **embeds},
                              cache_len=n_patches(embeds) + full.shape[1])
    c, pos, bp = cache["layers"][0], cache["pos"], params["layers"][0]
    check(pos == n_patches(embeds) + prompts.shape[1],
          f"{cfg.name}: pos {pos} after a prefill of {n_patches(embeds)} patches and "
          f"{prompts.shape[1]} tokens")
    if cfg.encoder_layers:
        got = lm.attn_mod.cross_decode(bp["xattn"], x, cfg, c["xk"], c["xv"])
    else:
        positions = torch.full((full.shape[0], 1), pos, dtype=torch.int32, device=full.device)
        got, _ = real(bp["attn"], x, cfg, positions=positions, cache={"k": c["k"], "v": c["v"]},
                      cache_len=pos)
    return position_gap(got, want)


def decode_row_check(fv: dict, r: dict, batch: int, faults: dict) -> None:
    """:func:`decode_row_gap` on wave 0's prompts, embeddings and first
    served tokens within LAYER_REL_L2 (the two differ by the kernel's
    rounding); each planted fault of ``faults`` must break it."""
    prompts, embeds = fv["prompts"][:batch], rows_of(fv["embeds"], slice(0, batch))
    fed = torch.tensor([[r["tokens"][i][0]] for i in range(batch)], device=prompts.device)
    what = "cross-attention" if fv["cfg"].encoder_layers else "self-attention"
    gap = decode_row_gap(fv, prompts, fed, embeds)
    print(f"{fv['label']}: first layer's {what} at decode (pos "
          f"{n_patches(embeds) + prompts.shape[1]} after the prefill) over the prefill's cache "
          f"vs in a prefill of prompt + 1, the same input row: largest relative L2 {gap:.6f} "
          f"(limit {LAYER_REL_L2})", flush=True)
    check(gap <= LAYER_REL_L2, f"{fv['cfg'].name}: the decode {what} within {LAYER_REL_L2}")
    for fault, plant in faults.items():
        bad = decode_row_gap(fv, prompts, fed, embeds, plant)
        print(f"{fv['label']}: planted fault '{fault}': decode {what} gap {bad:.6f} "
              f"(limit {LAYER_REL_L2})", flush=True)
        check(bad > LAYER_REL_L2, f"{fv['cfg'].name}: the decode {what} check catches '{fault}'")


def same_frontend(a: dict, b: dict, fz: dict, fv: dict) -> None:
    """:func:`same_logits`; the first attention calls of wave 0's prefill
    (seamless: the first encoder layer's self-attention and the first
    decoder layer's cross-attention, on the inputs the kernel run gave
    them; internvl: the first layer's, the model cut to it) kernel vs plain
    within LAYER_REL_L2, and the encoder run causally must break that; then
    the decode check (:func:`decode_row_check`: the cross carry, or the
    positions after the patches), which each planted fault must break.
    (:func:`check_serving` already held the decode logits against a prefill
    of the same tokens at SERVE_REL_L2.)"""
    same_logits(a, b, fz, fv)
    cfg, rows = fv["cfg"], slice(0, fz["batch"])
    if cfg.encoder_layers:
        calls = attention_calls(fv["params"], cfg, fv["prompts"][rows],
                                rows_of(fv["embeds"], rows))
        gaps = {role: call_gap(calls[role]) for role in ("encoder", "cross")}
        bad = call_gap(calls["encoder"], plant=(ops, "flash_attention", _causal_encoder))
        print(f"{fv['label']}: first encoder layer's attention and first decoder layer's "
              f"cross-attention (q {tuple(calls['cross'][0][1].shape)} over "
              f"{tuple(calls['cross'][1]['kv_source'].shape)}), kernel vs plain, largest "
              f"relative L2 over positions {gaps} (limit {LAYER_REL_L2}); planted fault "
              f"'encoder run causally': {bad:.6f}", flush=True)
        check(all(g <= LAYER_REL_L2 for g in gaps.values()),
              f"{cfg.name}: first encoder and cross attention within {LAYER_REL_L2}")
        check(bad > LAYER_REL_L2, f"{cfg.name}: the encoder check catches a causal encoder")
        faults = CROSS_FAULTS
    else:
        gap = first_layer_gap(fv, fv["prompts"][rows], rows_of(fv["embeds"], rows))
        print(f"{fv['label']}: first layer, kernel vs plain attention output over "
              f"{n_patches(fv['embeds'])} patches and {fv['prompts'].shape[1]} tokens, largest "
              f"relative L2 over positions {gap:.6f} (limit {LAYER_REL_L2})", flush=True)
        check(gap <= LAYER_REL_L2,
              f"{cfg.name}: first-layer attention outputs within {LAYER_REL_L2}")
        faults = PATCH_FAULTS
    decode_row_check(fv, a, fz["batch"], faults)


def frontend_roles() -> dict:
    """Roles of the frontend cells' device time (see :func:`role_split`):
    the encoder (its attention and MLP go to their own roles, the flash
    kernel by name), the attention projections, decode attention over the
    cache (the self K/V and the cross K/V), the MLP; the rest is the
    embedding, the norms and the head."""
    return {"encoder": (lm, "encode"), "attention projections": (lm.attn_mod, "attention"),
            "cross decode": (lm.attn_mod, "cross_decode"),
            "decode attention": (lm.attn_mod, "decode_attention"), "MLP": (layers_mod, "mlp")}


def frontend_split(fz: dict, fv: dict) -> dict:
    """The device split by role of one prefill wave and one decode step
    through the kernels (after a warm wave and step)."""
    cfg, params = fv["cfg"], fv["params"]
    rows = slice(0, fz["batch"])
    batch = {"tokens": fv["prompts"][rows], **rows_of(fv["embeds"], rows)}
    cache_len = n_patches(fv["embeds"]) + fv["prompts"].shape[1] + fz["gen"]
    state = {}

    def prefill():
        state["cache"], lg = lm.prefill(params, cfg, batch, cache_len=cache_len)
        state["tok"] = lg.argmax(-1)[:, None]

    def decode():
        lm.decode_step(params, cfg, state["cache"], state["tok"])
    prefill()
    decode()
    torch.cuda.synchronize()
    out = {}
    for what, fn in (("prefill wave", prefill), ("decode step", decode)):
        trace = {}
        out[what] = split = role_split(fn, frontend_roles(), names=(("flash_fwd", "flash"),),
                                       trace=trace)
        print(f"{cfg.name} split {what} (device ms by role; wall {trace['wall_ms']:.2f} ms, "
              f"device {sum(trace['by_name'].values()):.2f} ms): "
              + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    return out


# --------------------------------------------------------------------------
# the float32 serve phase: serve.py's main with the reduced configurations
# --------------------------------------------------------------------------

#: the JAX package's own float32 configurations (configs.reduced), served
#: by serve.py's main at its default flags (16 requests, 4 slots); the
#: frontend models through serve(...) with their embeddings (the CLI serves
#: tokens only)
F32_SERVE_ARCHS = ("qwen3-4b", "gemma3-4b", "arctic-480b", "deepseek-v3-671b", "zamba2-7b",
                   "rwkv6-1.6b", "seamless-m4t-medium", "internvl2-76b")
#: the prompt length serve.main runs at (its --prompt-len default)
F32_SERVE_PROMPT_LEN = 32
#: relative L2 gap allowed between the kernel run's logits and the plain
#: run's at every step: both run in float32 (matmuls too: TF32 off) and
#: differ only in the attention's summation order and the kernel's 3xTF32
#: products (about 2**-20 of each product).  It sits between the sound
#: runs (below 1e-6) and the one-TF32-pass control (above 1e-4)
F32_SERVE_REL_L2 = 1e-5


def tf32_rounded(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds (10 mantissa bits, to
    nearest, ties away from zero): float32 operands the tensor cores take
    in one pass without loss."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _one_tf32_pass(real):
    def control(q, k, v, causal=True, window=0, impl="auto", **kw):
        return real(*(tf32_rounded(t) for t in (q, k, v)), causal=causal, window=window,
                    impl=impl, **kw)
    return control


def frontend_main(arch: str, dev) -> int:
    """What ``serve.main(["--arch", arch, "--reduced"])`` does at its
    defaults (seed 0: the model, 16 requests of 32 tokens in 4 slots, 16
    tokens each), for a frontend model, whose embeddings the CLI does not
    take: the prompts and each request's embeddings drawn as
    ``synth_batch`` draws them, served through ``serve(...)``."""
    cfg = reduced(get_config(arch))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    patches = cfg.frontend_len if cfg.frontend == "patch" else 0
    batch = frontend_batch(cfg, 16, patches + F32_SERVE_PROMPT_LEN, dev, 0)
    serve_cli.serve(params, cfg, batch.pop("tokens"), 4, 16, **batch)
    return 0


def _serve_tapped(arch: str, dev, plant=None, forced=None) -> dict:
    """``serve.main(["--arch", arch, "--reduced"])`` as a user runs it
    (``frontend_main`` for a frontend model), its ``serve`` call tapped
    for the model, the prompts, the embeddings, the tokens and every
    step's logits, and ``ops.flash_attention`` for the inputs and output of
    each call (wave 0's prefill makes the first ``flash_calls``).
    ``plant`` wraps ``ops.flash_attention``; ``forced`` feeds these tokens."""
    logits, calls, seen = {}, [], {}
    real_serve, real_attn = serve_cli.serve, ops.flash_attention
    attn = plant(real_attn) if plant else real_attn

    def keep(wave, step, lg):
        logits[wave, step] = lg.clone()

    def tap_serve(params, cfg, prompts, batch, gen, impl="auto", **embeds):
        seen.update(params=params, cfg=cfg, prompts=prompts, batch=batch, gen=gen,
                    embeds=embeds)
        seen["tokens"] = real_serve(params, cfg, prompts, batch, gen, impl, on_logits=keep,
                                    forced=forced, **embeds)
        return seen["tokens"]

    def tap_attn(q, k, v, causal=True, window=0, impl="auto", probs_bf16=False):
        check(not probs_bf16, "the float32 serve phase runs without probs_bf16")
        out = attn(q, k, v, causal=causal, window=window, impl=impl)
        if len(calls) < flash_calls(seen["cfg"]):
            calls.append((q.clone(), k.clone(), v.clone(), causal, window, out.clone()))
        return out
    serve_cli.serve, ops.flash_attention = tap_serve, tap_attn
    try:
        if get_config(arch).frontend is not None:
            rc = frontend_main(arch, dev)
        else:
            rc = serve_cli.main(["--arch", arch, "--reduced"]
                                + (["--cpu"] if dev.type == "cpu" else []))
    finally:
        serve_cli.serve, ops.flash_attention = real_serve, real_attn
    check(rc == 0 and "tokens" in seen, f"f32 serve {arch}: serve.main returned {rc}")
    return dict(seen, logits=logits, calls=calls)


def f32_serve_path(impl: str, arch: str, runs: dict, dev) -> dict:
    """``impl="auto"``: serve.main as a user runs it (``_serve_tapped``).
    ``impl="torch"``: the same model and prompts through ``serve`` on the
    plain versions, teacher-forced with the kernel run's tokens."""
    if impl == "auto":
        return dict(_serve_tapped(arch, dev), impl=impl)
    a, logits = runs["auto"], {}
    forced = torch.tensor([a["tokens"][i] for i in range(len(a["tokens"]))], device=dev)
    tokens = serve(a["params"], a["cfg"], a["prompts"], a["batch"], a["gen"], "torch",
                   forced=forced, on_logits=lambda w, st, lg: logits.__setitem__((w, st),
                                                                               lg.clone()),
                   **a["embeds"])
    return dict(a, tokens=tokens, logits=logits, impl=impl)


def check_f32_serve(r: dict) -> None:
    """A float32 model; one prefill and gen decode steps of finite logits
    per wave; gen in-vocab tokens per request; on the card, the kernel run
    launched flash_attention_f32 once per attention layer and wave, each
    mixer's scan once per layer and call, and nothing else but, for an MoE
    model, the wire kernels of each layer's dispatch."""
    cfg, gen = r["cfg"], r["gen"]
    n_req = r["prompts"].shape[0]
    n_waves = -(-n_req // r["batch"])
    check(cfg.dtype == "float32" and r["params"]["embed"].dtype == torch.float32,
          f"f32 serve {cfg.name}: a float32 model")
    check(sorted(r["logits"]) == [(w, st) for w in range(n_waves) for st in range(gen + 1)],
          f"f32 serve {cfg.name}: one prefill and {gen} decode steps of logits per wave")
    check(all(bool(torch.isfinite(lg).all()) for lg in r["logits"].values()),
          f"f32 serve {cfg.name}: finite logits")
    check(len(r["tokens"]) == n_req and all(
        len(t) == gen and all(0 <= x < cfg.vocab for x in t) for t in r["tokens"].values()),
        f"f32 serve {cfg.name}: {gen} in-vocab tokens per request")
    if r["impl"] == "auto" and r["prompts"].is_cuda:
        counts = {k: n for k, n in r["launches"].items() if n}
        want = serving_launches(cfg, n_waves, gen, r["prompts"].shape[1])
        if cfg.moe is not None:
            want.update(moe_wire_launches(cfg, n_waves * (gen + 1)))
        check(counts == want,
              f"f32 serve {cfg.name}: flash_attention_f32 once per attention layer and wave "
              f"({n_waves}), the scans once per mixer layer and call, no other kernel (the "
              f"bf16 route included) but the MoE wire's: want {want}, got {counts}")


def _logits_gap(a: dict, b: dict) -> dict:
    vocab = a["cfg"].vocab
    return {key: rel_l2(b["logits"][key][:, :vocab], a["logits"][key][:, :vocab])
            for key in a["logits"]}


def same_f32_serve(a: dict, b: dict, dev) -> None:
    """Each flash call of wave 0's prefill (one per attention layer; an
    encoder-decoder's encoder layers and cross-attentions too), as the
    kernel run made it, within 3e-5 of the plain version on its inputs; the
    plain run's logits within F32_SERVE_REL_L2 of the kernel run's at every
    (wave, step).  Then, for a model with attention layers, a control:
    serve.main again with Q, K and V rounded to TF32 before the kernel, fed
    the kernel run's tokens; both checks must catch it.  For a model with
    mixer layers, the state carry (:func:`state_carry_check`), for an
    encoder-decoder the cross carry and for a patch model the decode after
    the patches (:func:`carry_check`), within F32_SERVE_REL_L2, their
    planted faults past FAULT_FACTOR times that."""
    name, m = a["cfg"].name, a["cfg"].mla
    check(len(a["calls"]) == flash_calls(a["cfg"]),
          f"f32 serve {name}: wave 0's prefill calls captured, {flash_calls(a['cfg'])}")
    if m is not None:   # MLA: D = nope + rope, V zero past v_head_dim
        dq = m.qk_nope_head_dim + m.qk_rope_head_dim
        check(all(q.shape[-1] == v.shape[-1] == dq and not bool(v[..., m.v_head_dim:].any())
                  for q, _, v, *_ in a["calls"]),
              f"f32 serve {name}: MLA prefill calls at D={dq}, V zero past {m.v_head_dim}")
    for i, (q, k, v, causal, window, out) in enumerate(a["calls"]):
        err, _ = attention_close(out, fa.flash_attention_plain(q, k, v, causal=causal,
                                                               window=window),
                                 f"f32 serve {name}: prefill call {i}, kernel vs plain")
        print(f"f32 serve {name}: prefill call {i} q {tuple(q.shape)} kv {tuple(k.shape)} "
              f"causal {causal} window {window}: max |kernel - plain| {err:.3g} "
              f"(atol=rtol=3e-5)", flush=True)
    errs = _logits_gap(a, b)
    worst = max(errs, key=errs.get)
    a["rel_l2_max"], a["rel_l2_mean"] = errs[worst], sum(errs.values()) / len(errs)
    print(f"f32 serve {name}: kernel vs plain logits, relative L2: max "
          f"{errs[worst]:.3g} at (wave, step) {worst}, mean {a['rel_l2_mean']:.3g} "
          f"(limit {F32_SERVE_REL_L2:g})", flush=True)
    check(errs[worst] <= F32_SERVE_REL_L2,
          f"f32 serve {name}: kernel and plain logits within relative L2 "
          f"{F32_SERVE_REL_L2:g}")
    if set(a["cfg"].layer_pattern) & set(STATE_FAULTS):
        state_carry_check(a, F32_SERVE_REL_L2)
    if a["cfg"].encoder_layers:
        carry_check("cross carry", a, F32_SERVE_REL_L2, CROSS_FAULTS, FAULT_FACTOR)
    if a["cfg"].frontend == "patch":
        carry_check("decode after the patches", a, F32_SERVE_REL_L2, PATCH_FAULTS, FAULT_FACTOR)
    if not a["calls"]:
        return
    forced = torch.tensor([a["tokens"][i] for i in range(len(a["tokens"]))], device=dev)
    c = _serve_tapped(name, dev, plant=_one_tf32_pass, forced=forced)
    missed = sum(f32_within(out, fa.flash_attention_plain(q, k, v, causal=causal,
                                                          window=window))
                 for q, k, v, causal, window, out in c["calls"])
    a["control_rel_l2_max"] = max(_logits_gap(c, b).values())
    print(f"f32 serve {name}: control (Q, K, V rounded to TF32): prefill calls within "
          f"3e-5 {missed}/{len(c['calls'])}; logits relative L2 max "
          f"{a['control_rel_l2_max']:.3g} (limit {F32_SERVE_REL_L2:g})", flush=True)
    check(missed == 0 and a["control_rel_l2_max"] > F32_SERVE_REL_L2,
          f"f32 serve {name}: the per-call and the logits checks catch one TF32 pass")


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# the multi-rank cells: four gloo ranks, (data 1, model 4), on the one card
# --------------------------------------------------------------------------

MR_RANKS = 4
#: the MoE agreement check's slack: the old every-rank dispatch drops there
MR_DROP_SLACK = 1.0
MR_RANKS_TIMEOUT_S = 900
#: each kind's first layer's output (before the final norm: READ_AT) at four
#: ranks against one rank's, relative L2 over the whole output (prefill and
#: decode): sound 9.7e-5 to 2.3e-3 on an H100 (seamless-m4t-medium's decoder
#: layer the largest), the faults 8.9e-3 (RWKV's decay columns of the
#: neighbouring heads, in the time mix) to 1.4
MR_LAYER_REL_L2 = 5e-3
#: largest per-position relative L2 gap of the first layer's output over a
#: prefill's (or the encoder's) positions at four ranks to one rank's (at
#: decode, LAYER_REL_L2, as at one rank).  Over 8 x 1024 or 8 x 2048
#: positions a few differ by one-ulp bf16 flips of the summed partials:
#: sound 5.6e-3 to 9.5e-3 on an H100 (9.2e-3 in qwen3-4b with each partial
#: rounded to bf16); the faults at prefill 1.4e-2 (RWKV's decay columns, which
#: MR_LAYER_REL_L2 catches) and 0.15 to 1.5
MR_PREFILL_POSITION_GAP = 3e-2
#: deepseek-v3's options in its multi-rank cell, at which no MoE copy drops on
#: the wire at one rank or four: one row per (token, owner rank), whose wire
#: capacity n_tok * min(k, expected owners) / P * slack holds all of a rank's
#: n_tok rows to one destination once slack >= P / min(k, expected owners):
#: 1.11 at full width (top-8 of 256), under the config's 1.5; 2.29 for the
#: rehearsal's reduced model (top-2 of 8), which runs at 2.5.  One row per
#: (token, expert) would need a slack of 3.75 for four ranks' 16 decode
#: copies to fit a destination's int(4 * slack) + 1 slots; at one rank that
#: slack makes the wire's send and reply buffers 7.5 GB each beside 31.6 GB
#: of weights, and 8.0 raises past 2**31 wire words.  An expert's bins
#: (int(B*T*k*P/E * slack) + 1 a rank) hold one copy at decode at any slack
#: that fits, so copies past them drop at one rank and at four alike (each
#: owner bins its arrivals in token order; bf16 runs can route a near tie
#: differently), and the cell prints how many.
MR_DEEPSEEK = dict(mla_absorb=True, mla_cp_decode=True, moe_dedup_dispatch=True)
#: the cells, each its P=1 cell's model and a wave of 8 of its requests; the
#: recurrent and encoder-decoder ones: zamba2-7b at full width cut to 12 of 81
#: layers (``mmmmma`` twice: the shared block runs twice on one parameter
#: set), 28 Mamba2 heads, 8 attention heads over 8 kv heads a rank; rwkv6-1.6b
#: whole, 8 of 32 heads a rank; seamless-m4t-medium whole (12 + 12 layers), 4
#: of 16 heads a rank, each request's 512 source frames as its P=1 cell draws
#: them (``seq``: ``frontend_batch``).  16 tokens for the recurrent cells,
#: whose prefills make the most all-reduces of 235 MB and 134 MB.
MR_FULL = (dict(arch="qwen3-4b", reduced=False, layers=None, requests=16, batch=8,
                prompt_len=2048, gen=32, over={}),
           dict(arch="deepseek-v3-671b", reduced=False, layers=4, requests=16, batch=8,
                prompt_len=1024, gen=16, over=MR_DEEPSEEK),
           dict(arch="zamba2-7b", reduced=False, layers=12, requests=16, batch=8,
                prompt_len=2048, gen=16, over={}),
           dict(arch="rwkv6-1.6b", reduced=False, layers=None, requests=16, batch=8,
                prompt_len=2048, gen=16, over={}),
           dict(arch="seamless-m4t-medium", reduced=False, layers=None, requests=16, batch=8,
                seq=2048, gen=32, over={}))
MR_REHEARSAL = (dict(arch="qwen3-4b", reduced=True, layers=None, requests=4, batch=4,
                     prompt_len=40, gen=4, over={}),
                dict(arch="deepseek-v3-671b", reduced=True, layers=2, requests=4, batch=4,
                     prompt_len=40, gen=4, over=dict(MR_DEEPSEEK, moe_capacity_slack=2.5)),
                # reduced zamba2-7b's Mamba2 at 8 heads (2 a rank; the reduced config has 2)
                dict(arch="zamba2-7b", reduced=True, layers=None, requests=4, batch=4,
                     prompt_len=40, gen=4,
                     over=dict(ssm=dataclasses.replace(reduced(get_config("zamba2-7b")).ssm,
                                                       n_heads=8))),
                # 512 steps: a decay column acts on the ~150 steps a state keeps
                # (exp(-exp(-5)) a step), so a neighbour's columns (the same w0,
                # only ww's small terms apart) moved the time mix by 2.9e-3 at 40
                # steps, under the check's 5e-3, and past it here
                dict(arch="rwkv6-1.6b", reduced=True, layers=None, requests=4, batch=4,
                     prompt_len=512, gen=4, over={}),
                dict(arch="seamless-m4t-medium", reduced=True, layers=None, requests=4, batch=4,
                     seq=40, gen=4, over={}))


def mr_config(mz: dict):
    """The cell's model: the config (reduced, cut to ``layers``) with the
    cell's options."""
    cfg = get_config(mz["arch"])
    if mz["reduced"]:
        cfg = reduced(cfg)
    if mz["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=mz["layers"])
    return dataclasses.replace(cfg, **mz["over"])


def mr_prompts(mz: dict, cfg, seed: int, dev) -> tuple[torch.Tensor, dict]:
    """The first ``batch`` of the one-rank cell's prompts (its seeded draw)
    and their frontend embeddings (a frontend cell's ``frontend_batch``,
    as ``frontend_setup`` draws it)."""
    if cfg.frontend:
        batch = frontend_batch(cfg, mz["requests"], mz["seq"], dev, seed)
        return batch.pop("tokens")[:mz["batch"]], rows_of(batch, slice(0, mz["batch"]))
    p = np.random.default_rng(seed).integers(0, cfg.vocab, (mz["requests"], mz["prompt_len"]),
                                             dtype=np.int32)
    return torch.from_numpy(p[:mz["batch"]]).to(dev), {}


def route_of(params, x: torch.Tensor, cfg, load: torch.Tensor) -> dict:
    """One moe_apply call's routing, from the router on its input: each
    token's top-k expert ids (sorted), its top-k score margin (k-th minus
    (k+1)-th) and the copies each expert served (``expert_load``), left
    on the device (no sync inside a timed step)."""
    _, idx, _, scores = moe_mod.router_topk(params, x, cfg)
    k = cfg.moe.top_k
    s = scores.sort(dim=-1, descending=True).values
    return dict(ids=idx.reshape(-1, k).sort(dim=-1).values.to(torch.int16),
                margin=(s[..., k - 1] - s[..., k]).reshape(-1).float(), load=load.float())


@contextlib.contextmanager
def moe_stats(seen: list, routes: list | None = None, calls: dict | None = None):
    """Each moe_apply call's (token copies, copies its experts served,
    copies the wire dropped) while the block runs; with ``routes``, each
    call's :func:`route_of`; with ``calls``, the first prefill-shaped and
    the first decode-shaped call's (params, x, outputs)."""
    real = moe_mod.moe_apply

    def tap(params, x, cfg, layout=None, impl="auto"):
        out = real(params, x, cfg, layout, impl=impl)
        nd = 1 if layout is None else layout.data
        seen.append((x.shape[0] * x.shape[1] * cfg.moe.top_k * nd,
                     int(out[2]["expert_load"].sum()), int(out[2]["dispatch_dropped"])))
        if routes is not None:
            routes.append(route_of(params, x, cfg, out[2]["expert_load"]))
        if calls is not None:
            calls.setdefault("prefill" if x.shape[1] > 1 else "decode", (params, x, out))
        return out
    moe_mod.moe_apply = tap
    try:
        yield
    finally:
        moe_mod.moe_apply = real


def lost_copies(seen: list) -> dict:
    """Wire drops and bin overflows summed over the calls."""
    return {"wire_dropped": sum(d for _, _, d in seen),
            "bin_overflow": sum(n - served - d for n, served, d in seen)}


def mr_first_layers(params, cfg, prompts: torch.Tensor, token: torch.Tensor, embeds: dict,
                    layout=None) -> dict:
    """The first layer of each kind the model runs, alone (``lm.forward`` of
    the model cut to that one layer; an encoder-decoder's encoder cut to its
    first block): its output (before the final norm, :data:`READ_AT`) at
    the prefill of ``prompts`` with the frontend's ``embeds`` and at the
    decode of ``token`` after it, as "<kind> prefill" and "<kind> decode"
    (an ``r`` layer's time mix and channel mix outputs apart too); an
    encoder-decoder's first encoder block's output as "encoder"."""
    out = {}
    b, t = prompts.shape
    src = embeds.get("src_embeds")
    for kind in dict.fromkeys(cfg.layer_pattern):
        i = next(i for i in range(cfg.n_layers) if lm.kind_at(cfg, i) == kind)
        cfg1 = dataclasses.replace(cfg, n_layers=1, layer_pattern=kind,
                                   encoder_layers=min(cfg.encoder_layers, 1))
        p1 = dict(params, layers=params["layers"][i:i + 1])
        if cfg.encoder_layers:
            p1["encoder"] = params["encoder"][:1]
        cache = lm.cache_init(cfg1, b, n_patches(embeds) + t + MR_RANKS, prompts.device,
                              cross_len=0 if src is None else src.shape[1], layout=layout)
        for phase in ("prefill", "decode"):
            seen = {}
            with outputs_read(seen):
                _, cache = lm.forward(p1, cfg1, prompts if phase == "prefill" else token,
                                      cache=cache, decode=phase == "decode", layout=layout,
                                      **(embeds if phase == "prefill" else {}))
            out[f"{kind} {phase}"] = seen.pop("layer")
            seen.pop("encoder", None)
            out.update({f"{kind} {mix} {phase}": y for mix, y in seen.items()})
    if src is not None:
        seen = {}
        with outputs_read(seen):
            lm.encode(p1, cfg1, src, layout=layout)
        out["encoder"] = seen["encoder"]
    return out


#: the outputs the first-layer check reads, by (owner, function): a layer
#: (``lm._apply_block``) and an encoder block before the final norms (a
#: row's bf16 norm scale that rounds one ulp apart moves the whole row by
#: 2**-8 to 2**-7, which a per-position limit of 5e-3 cannot tell from a
#: fault), and RWKV-6's time mix and channel mix apart (the decay acts
#: inside the time mix, the residual around both)
READ_AT = {(lm, "_apply_block"): "layer", (lm, "_encoder_block"): "encoder",
           (ssm_mod, "rwkv_apply"): "time mix", (ssm_mod, "rwkv_channel_mix"): "channel mix"}


@contextlib.contextmanager
def tapped(targets, record):
    """While the block runs, each ``(owner, name)`` of ``targets`` calls
    through: ``record((owner, name), args, outputs)`` after every call."""
    reals = {key: getattr(*key) for key in targets}

    def tap(key):
        def call(*args, **kwargs):
            out = reals[key](*args, **kwargs)
            record(key, args, out)
            return out
        return call
    for key in reals:
        setattr(*key, tap(key))
    try:
        yield
    finally:
        for key, real in reals.items():
            setattr(*key, real)


def outputs_read(seen: dict):
    """While the block runs, the first output of each :data:`READ_AT`
    function's last call, by its label."""
    return tapped(READ_AT, lambda key, args, out: seen.__setitem__(
        READ_AT[key], out[0] if isinstance(out, tuple) else out))


def layer_gaps(got: dict, want: dict) -> dict:
    """Each first-layer reading's gap to the one-rank run's: relative L2
    over the whole output and the largest per-position one."""
    return {k: dict(rel=rel_l2(got[k], want[k]), pos=position_gap(got[k], want[k])) for k in want}


def layer_within(g: dict) -> bool:
    """Every first-layer reading at four ranks within its limits: the whole
    output within MR_LAYER_REL_L2, each position within
    MR_PREFILL_POSITION_GAP over many positions (a prefill, the encoder)
    and LAYER_REL_L2 at decode."""
    return all(v["rel"] <= MR_LAYER_REL_L2
               and v["pos"] <= (LAYER_REL_L2 if k.endswith("decode") else MR_PREFILL_POSITION_GAP)
               for k, v in g.items())


def first_scans(seen: dict):
    """While the block runs, each scan's first prefill (T > 1) and first
    decode call at ``ops`` as served: ``seen[(name, "prefill" | "decode")]
    = (operands, outputs)``."""
    return tapped([(ops, "mamba_scan"), (ops, "rwkv_scan")], lambda key, args, out: seen.setdefault(
        (key[1], "prefill" if args[0].shape[1] > 1 else "decode"), (args, out)))


def scans_held(seen: dict) -> dict:
    """Each captured scan call's served outputs against the plain version
    on the same operands: the kernel its shape picks, the operands' shape,
    the output's and the final state's relative L2 gaps."""
    out = {}
    for (name, label), (args, got) in seen.items():
        want = getattr(ssm_scan, name + "_plain")(*args)
        out[f"{name} {label}"] = dict(kernel=scan_kernel(name, args),
                                      shape=list(args[0].shape),
                                      output=rel_l2(got[0], want[0]), state=rel_l2(got[1], want[1]))
    return out


def rank_param_bytes(cfg, nm: int, r: int) -> int:
    """The bytes model rank ``r`` of ``nm`` holds: ``shard_params`` of the
    whole model's tree on the ``meta`` device."""
    lay = sharding.Layout(1, nm, 0, r, SerialBackend(), SerialBackend())
    return _tree_bytes(sharding.shard_params(lm.abstract_params(cfg), cfg, lay))


def mr_launches(cfg, gen: int, prompt_len: int, nm: int) -> dict:
    """One of ``nm`` model ranks' launches of one wave: flash once per
    attention call, the scans once per mixer layer and call, and each MoE
    layer's wire kernels once per pass."""
    want = serving_launches(cfg, 1, gen, prompt_len, nm)
    if cfg.moe is not None:
        want.update(moe_wire_launches(cfg, gen + 1))
    return want


def mr_reference(mz: dict, cfg, dev, seed: int, path: Path) -> dict:
    """The one-rank run of the cell on this process: serve the wave (the
    kernels), its tokens, every step's logits and the first layer's outputs
    saved to ``path`` for the ranks."""
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    prompts, embeds = mr_prompts(mz, cfg, seed, dev)
    logits, timings, stats, routes = {}, {}, [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with moe_stats(stats, routes):
        toks = serve(params, cfg, prompts, mz["batch"], mz["gen"], "auto", timings=timings,
                     on_logits=lambda w, s, lg: logits.__setitem__(s, lg.float().cpu()),
                     **embeds)
    sync(dev)
    launches = build.launch_counts()
    forced = torch.tensor([toks[i] for i in range(mz["batch"])])
    first = mr_first_layers(params, cfg, prompts, forced[:, :1].to(dev), embeds)
    routes = [{k: v.cpu() for k, v in rt.items()} for rt in routes]
    torch.save(dict(prompts=prompts.cpu(), embeds={k: e.cpu() for k, e in embeds.items()},
                    forced=forced, logits=logits, routes=routes,
                    first={k: v.float().cpu() for k, v in first.items()}), path)
    return dict(timings=timings, lost=lost_copies(stats), n_params=_tree_sum(params),
                tokens=forced.tolist(), launches=launches, prompt_len=prompts.shape[1],
                peak=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None)


def _vocab_shifted(real):
    """Fault: each rank reads its vocab shard one row off."""
    def fault(table_loc, tokens, bk):
        return real(table_loc.roll(1, dims=0), tokens, bk)
    return fault


def _psum_skipped(real):
    """Fault: the heads' partial outputs after ``wo`` not summed."""
    return lambda x, w_loc, bk: x @ w_loc


def _cp_unscaled(real):
    """Fault: the context-parallel combine sums the ranks' partials without
    rescaling each by exp(m_i - M)."""
    def fault(bk, m_i, l_i, ctx_i):
        return bk.psum(ctx_i) / bk.psum(l_i).clamp(min=1e-30)[..., None]
    return fault


def _norm_local(real):
    """Fault: the gated norm over this rank's columns only."""
    return lambda x, gamma_loc, eps, bk: layers_mod.rms_norm(x, gamma_loc, eps)


def _bc_split_with_heads(real):
    """Fault: the B/C columns split over the ranks with the heads, as JAX's
    contiguous ``in_proj`` rule read literally hands them out: each rank
    sees its own share of B's and of C's state columns (the rest zero)."""
    def fault(params, x, cfg, state=None, impl="auto", bk=None):
        nm, r = bk.nprocs(), bk.rank()
        ds, il = cfg.ssm.d_state, params["norm"].shape[0]
        keep = torch.ones(params["in_proj"].shape[1], dtype=torch.bool, device=x.device)
        for lo in (2 * il, 2 * il + ds):             # B's columns, then C's
            keep[lo:lo + ds] = False
            keep[lo + r * ds // nm:lo + (r + 1) * ds // nm] = True
        return real(dict(params, in_proj=params["in_proj"] * keep), x, cfg, state,
                    impl=impl, bk=bk)
    return fault


def _cols_shifted(real):
    """Fault: the decay columns of the neighbouring rank's heads."""
    def fault(bk, n):
        r = (bk.rank() + 1) % bk.nprocs()
        return slice(r * n, (r + 1) * n)
    return fault


def _cross_unsummed(real):
    """Fault: ``cross_decode`` without its psum after ``wo``."""
    return lambda params, x, cfg, xk, xv, bk=None: real(params, x, cfg, xk, xv)


def _encoder_mlp_unsummed(real):
    """Fault: the encoder blocks' MLP outputs not summed over the ranks
    (the decoder's are)."""
    def fault(params, cfg, src_embeds, *, impl="auto", layout=None):
        with planted((layers_mod, "mlp",
                      lambda m: lambda p, x, activation="swiglu", bk=None: m(p, x, activation))):
            return real(params, cfg, src_embeds, impl=impl, layout=layout)
    return fault


def mr_faults(cfg) -> dict:
    """The faults the first-layer check must see: the vocab shard's always,
    and each of the model's kinds' (attention's psum, Mamba2's, RWKV-6's,
    the encoder-decoder's, the CP combine's where the cell decodes
    context-parallel)."""
    kinds = set(cfg.layer_pattern)
    faults = {"a vocab shard read one row off": (layers_mod, "embed_lookup", _vocab_shifted)}
    if kinds & set("gla") or cfg.encoder_layers:
        faults["the psum after wo skipped"] = (lm.attn_mod, "row_parallel", _psum_skipped)
    if "m" in kinds:
        faults["Mamba2's gated norm over the rank's slice only"] = (
            ssm_mod, "rms_norm_split", _norm_local)
        faults["the B/C columns split with the heads"] = (
            ssm_mod, "mamba_apply", _bc_split_with_heads)
        faults["the psum after out_proj skipped"] = (ssm_mod, "row_parallel", _psum_skipped)
    if "r" in kinds:
        faults["RWKV's ln_x over the rank's slice only"] = (ssm_mod, "rms_norm_split",
                                                             _norm_local)
        faults["the decay columns taken from the neighbouring rank's heads"] = (
            ssm_mod, "rank_cols", _cols_shifted)
        faults["the psum after wo and the channel mix's w_out skipped"] = (
            ssm_mod, "row_parallel", _psum_skipped)
    if cfg.encoder_layers:
        faults["cross_decode without its psum"] = (lm.attn_mod, "cross_decode", _cross_unsummed)
        faults["the encoder MLP's psum skipped"] = (lm, "encode", _encoder_mlp_unsummed)
    if cfg.mla is not None and cfg.mla_absorb and cfg.mla_cp_decode:
        faults["the CP combine without its exp(m_i - M) rescale"] = (
            lm.attn_mod, "_cp_combine", _cp_unscaled)
    return faults


def moe_agreement(params, cfg, lay, batch: int, seed: int, dev, plant=None) -> dict:
    """The first MoE layer on a decode-shaped input (batch, 1, D) at
    ``MR_DROP_SLACK``: the largest gap between this rank's output and any
    other model rank's, the (token, expert) copies, and the copies served
    (summed over the owners: each rank's own under the old dispatch) and
    dropped on the wire."""
    i = next(i for i in range(cfg.n_layers) if lm._layer_is_moe(cfg, i))
    x = (torch.randn((batch, 1, cfg.d_model), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed + 1))
         .to(lm.dtype_of(cfg)))
    with planted(plant):
        y, _, st = moe_mod.moe_apply(params["layers"][i]["moe"], x,
                                     dataclasses.replace(cfg, moe_capacity_slack=MR_DROP_SLACK),
                                     lay)
    every = lay.model_bk.all_gather(y.float())
    return dict(gap=float((every - y.float()).abs().max()), copies=batch * cfg.moe.top_k,
                served=int(st["expert_load"].sum()), wire_dropped=int(st["dispatch_dropped"]))


def moe_rank_exact(call: tuple, cfg, lay, plant=None) -> dict:
    """One moe_apply call of a rank's served run, as it ran through the wire
    kernels (its input and outputs), against moe_apply on the same input
    and layout with the plain versions: ``y``, ``expert_load`` and the
    drops bit for bit.  ``plant`` wraps ``binning.pack_rows`` for a rerun
    through the kernels, whose outputs then stand in for the served ones."""
    p, x, (y, _, st) = call
    if plant is not None:
        with planted((binning, "pack_rows", plant)):
            y, _, st = moe_mod.moe_apply(p, x, cfg, lay)
    y2, _, st2 = moe_mod.moe_apply(p, x, cfg, lay, impl="torch")
    return dict(shape=list(x.shape), y=torch.equal(y, y2),
                load=torch.equal(st["expert_load"], st2["expert_load"]),
                dropped=torch.equal(st["dispatch_dropped"], st2["dispatch_dropped"]),
                served=int(st["expert_load"].sum()))


def routing_apart(one: list, four: list, n_experts: int) -> list:
    """The MoE calls at which four ranks' experts served another count of
    copies than one rank's experts did.  Per call: how many experts, how
    many of them no changed top-k set explains (a copy moved onto or off
    the expert between the runs), and the one-rank top-k margin of each
    token that moved a copy onto or off one of them."""
    def picks(ids):
        return torch.zeros(ids.shape[0], n_experts, dtype=torch.bool).scatter_(1, ids.long(),
                                                                               True)
    check(len(one) == len(four), f"one rank and four make as many MoE calls: {len(one)}, "
                                 f"{len(four)}")
    out = []
    for c, (a, b) in enumerate(zip(one, four)):
        experts = torch.nonzero(a["load"] != b["load"]).flatten()
        if not len(experts):
            continue
        moved = (picks(a["ids"]) ^ picks(b["ids"]))[:, experts]      # (tokens, experts)
        out.append(dict(call=c, experts=len(experts),
                        unexplained=int((~moved.any(dim=0)).sum()),
                        margins=a["margin"][moved.any(dim=1)].tolist()))
    return out


def _old_dispatch(real):
    """Fault: every rank dispatches every token, as the JAX package does at
    T % P != 0, and keeps its own output."""
    return lambda b, t, nm: "all"


def mr_rank_run(rank: int, mz: dict, seed: int, ref_path: str, dev) -> dict:
    """One rank of a multi-rank cell: its slice of the seeded model, the
    wave served teacher-forced with the one-rank run's tokens (launches
    counted; each scan's first prefill and decode call kept and held
    against its plain version), then the first-layer check, the planted
    faults and the MoE agreement check; for an MoE model the first prefill
    and decode MoE calls of the wave rerun with the plain wire versions,
    and each call's expert loads against the one-rank run's."""
    from repro_torch.models.sharding import Layout
    cfg = mr_config(mz)
    lay = Layout.over(1, MR_RANKS)
    ref = torch.load(ref_path)
    prompts, forced = ref["prompts"].to(dev), ref["forced"].to(dev)
    embeds = {k: e.to(dev) for k, e in ref["embeds"].items()}
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev, lay)
    sync(dev)
    res = dict(rank=rank, init_s=time.perf_counter() - t0, param_bytes=_tree_bytes(params))

    gaps, picks, timings, stats, busy, routes, calls, scans = {}, [], {}, [], {}, [], {}, {}
    vocab = cfg.vocab

    def keep(wave, step, lg):
        picks.append(lg.argmax(dim=-1).tolist())
        gaps[step] = rel_l2(lg[:, :vocab], ref["logits"][step][:, :vocab].to(dev))
        if dev.type == "cuda" and step == mz["gen"] - 1:      # profile the last decode step
            from torch.profiler import ProfilerActivity, profile
            busy["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            sync(dev)
            busy["prof"].start()
            busy["t0"] = time.perf_counter()
        elif "prof" in busy and step == mz["gen"]:
            sync(dev)
            busy["wall_ms"] = (time.perf_counter() - busy.pop("t0")) * 1e3
            busy["prof"].stop()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with moe_stats(stats, routes, calls), first_scans(scans):
        serve(params, cfg, prompts, mz["batch"], mz["gen"], "auto", forced=forced,
              on_logits=keep, timings=timings, layout=lay, **embeds)
    sync(dev)
    res.update(launches=build.launch_counts(), logits_rel_l2=gaps, picks=picks,
               lost=lost_copies(stats), ttft_s=timings["prefill_s"][0],
               decode_ms=float(np.median(timings["decode_s"])) * 1e3,
               peak_bytes=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None)
    if "prof" in busy:
        from torch.autograd import DeviceType
        device_ms = sum((ev.time_range.end - ev.time_range.start) / 1e3
                        for ev in busy["prof"].events() if ev.device_type == DeviceType.CUDA)
        res["busy"] = dict(device_ms=device_ms, wall_ms=busy["wall_ms"],
                           share=device_ms / busy["wall_ms"])

    res["scans"] = scans_held(scans)
    scans.clear()

    want = {k: w.to(dev) for k, w in ref["first"].items()}
    first = {}
    for name, plant in {"sound": None, **mr_faults(cfg)}.items():
        with planted(plant):
            got = mr_first_layers(params, cfg, prompts, forced[:, :1], embeds, lay)
        first[name] = layer_gaps(got, want)
    res["first_layer"] = first
    if cfg.moe is not None:
        res["moe_exact"] = {name: moe_rank_exact(call, cfg, lay) for name, call in calls.items()}
        if dev.type == "cuda":
            res["moe_exact"]["planted"] = moe_rank_exact(calls["decode"], cfg, lay,
                                                         plant=_swap_send_slots)
        calls.clear()
        res["routing_apart"] = routing_apart(
            ref["routes"], [{k: v.cpu() for k, v in rt.items()} for rt in routes],
            cfg.moe.n_experts)
        res["moe_agreement"] = {
            "repaired": moe_agreement(params, cfg, lay, mz["batch"], seed, dev),
            "every rank dispatches every token": moe_agreement(
                params, cfg, lay, mz["batch"], seed, dev,
                plant=(moe_mod, "token_split", _old_dispatch))}
    return res


def _mr_rank(rank: int, port: int, mz: dict, seed: int, ref_path: str, out_dir: str,
             device: str) -> None:
    """A spawned rank: gloo over localhost, every rank on the one card."""
    from datetime import timedelta

    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=MR_RANKS, rank=rank,
                            timeout=timedelta(seconds=MR_RANKS_TIMEOUT_S))
    try:
        res = mr_rank_run(rank, mz, seed, ref_path, dev)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def mr_spawn(mz: dict, seed: int, ref_path: Path, out_dir: Path, dev) -> list[dict]:
    """The cell's ``MR_RANKS`` ranks, spawned; each one's result."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_mr_rank, args=(port, mz, seed, str(ref_path), str(out_dir),
                                             dev.type),
                             nprocs=MR_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + MR_RANKS_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline,
                  f"the {MR_RANKS} ranks end within {MR_RANKS_TIMEOUT_S}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [json.loads(Path(out_dir, f"rank{r}.json").read_text()) for r in range(MR_RANKS)]


def check_multirank(ranks: list, one: dict, mz: dict, cfg, rehearsal: bool) -> None:
    """The gates of a multi-rank cell, each fatal; nothing is printed of a
    cell whose gate fails."""
    label = f"{cfg.name} P={MR_RANKS}"
    check(all(r["picks"] == ranks[0]["picks"] for r in ranks),
          f"{label}: every rank's greedy tokens at every step are the same")
    worst = max(max(r["logits_rel_l2"].values()) for r in ranks)
    check(worst <= SERVE_REL_L2, f"{label}: logits teacher-forced on the one-rank run's tokens "
                                 f"within {SERVE_REL_L2} of its logits: {worst}")
    for r in ranks:
        first = dict(r["first_layer"])
        check(layer_within(first.pop("sound")),
              f"{label} rank {r['rank']}: each kind's first layer within {MR_LAYER_REL_L2} "
              f"relative L2 of one rank's at prefill and decode (and the encoder's), its "
              f"positions within {MR_PREFILL_POSITION_GAP} at prefill and {LAYER_REL_L2} at "
              f"decode: {r['first_layer']['sound']}")
        for name, gap in first.items():
            check(not layer_within(gap),
                  f"{label} rank {r['rank']}: the fault '{name}' breaks the first-layer check: "
                  f"{gap}")
    want_bytes = [rank_param_bytes(cfg, MR_RANKS, r["rank"]) for r in ranks]
    check([r["param_bytes"] for r in ranks] == want_bytes,
          f"{label}: each rank holds the bytes shard_params gives it {want_bytes}: "
          f"{[r['param_bytes'] for r in ranks]}")
    scans = {f"{name} {call}" for kind, name in (("m", "mamba_scan"), ("r", "rwkv_scan"))
             if kind in cfg.layer_pattern for call in ("prefill", "decode")}
    for r in ranks:
        held = r["scans"]
        check(set(held) == scans and all(max(g["output"], g["state"]) <= SCAN_REL_L2
                                         for g in held.values()),
              f"{label} rank {r['rank']}: each scan's first served prefill and decode call "
              f"within {SCAN_REL_L2} of its plain version, output and state: {held}")
    if not rehearsal:
        for who, counts, nm in [("one rank", one["launches"], 1)] + [
                (f"rank {r['rank']}", r["launches"], MR_RANKS) for r in ranks]:
            want = mr_launches(cfg, mz["gen"], one["prompt_len"], nm)
            got = {k: n for k, n in counts.items() if n}
            check(got == want, f"{label} {who}: launches {got}, want {want}")
    lost = [one["lost"]] + [r["lost"] for r in ranks]
    check(all(d["wire_dropped"] == 0 for d in lost),
          f"{label}: no copy dropped on the wire, at one rank or any of {MR_RANKS}: "
          f"{[d['wire_dropped'] for d in lost]}")
    if cfg.moe is not None:
        for r in ranks:
            ex = r["moe_exact"]
            check(all(ex[c][k] for c in ("prefill", "decode") for k in ("y", "load", "dropped")),
                  f"{label} rank {r['rank']}: the first prefill and decode MoE calls through "
                  f"the wire kernels equal moe_apply with the plain versions bit for bit: {ex}")
            check(rehearsal or not ex["planted"]["y"],
                  f"{label} rank {r['rank']}: the exact check catches two swapped send slots")
            apart = r["routing_apart"]
            check(all(c["unexplained"] == 0 for c in apart),
                  f"{label} rank {r['rank']}: every expert whose served copies differ from one "
                  f"rank's has a copy moved onto or off it by a changed top-k set: {apart}")
            worst = max((m for c in apart for m in c["margins"]), default=0.0)
            check(worst < FLIP_MARGIN,
                  f"{label} rank {r['rank']}: each such copy's token at a top-k margin below "
                  f"{FLIP_MARGIN}: {worst}")
            agree = r["moe_agreement"]
            check(agree["repaired"]["gap"] == 0.0,
                  f"{label} rank {r['rank']}: every rank's MoE output the same: {agree}")
            check(agree["every rank dispatches every token"]["gap"] > 0.0,
                  f"{label} rank {r['rank']}: the old dispatch breaks the agreement: {agree}")


def multirank_cell(mz: dict, dev, seed: int, smi: str, rehearsal: bool) -> tuple:
    """The one-rank reference here, then ``MR_RANKS`` processes on the one
    card (gloo), their gates, then each rank's numbers.  Returns (the
    reference's results, each rank's)."""
    import tempfile
    cfg = mr_config(mz)
    t_c = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = Path(tmp, "ref.pt")
        one = mr_reference(mz, cfg, dev, seed, ref_path)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ranks = mr_spawn(mz, seed, ref_path, Path(tmp), dev)
    check_multirank(ranks, one, mz, cfg, rehearsal)
    fed = one["tokens"]
    agree = float(np.mean([ranks[0]["picks"][s][j] == fed[j][s]
                           for s in range(mz["gen"]) for j in range(mz["batch"])]))
    print(f"{cfg.name} P={MR_RANKS} (data 1, model {MR_RANKS}; gloo on one card, every rank "
          f"a process on the one device; collectives through host memory, none staged by the "
          f"port): one-rank TTFT {one['timings']['prefill_s'][0]:.3f}s, decode "
          f"{1e3 * float(np.median(one['timings']['decode_s'])):.1f} ms a step, peak "
          f"{one['peak']} bytes, {one['n_params']} parameters, MoE copies past their "
          f"experts' bins {one['lost']['bin_overflow']}; the ranks' greedy picks agree with "
          f"its tokens at {agree:.4f} of (slot, step)", flush=True)
    worst = {name: max(max(v["rel"] / MR_LAYER_REL_L2,
                           v["pos"] / (LAYER_REL_L2 if k.endswith("decode")
                                       else MR_PREFILL_POSITION_GAP)) for k, v in g.items())
             for name, g in ranks[0]["first_layer"].items()}
    print(f"{cfg.name} P={MR_RANKS} first-layer check, rank 0, each reading's gap over its "
          f"limit, the largest: " + json.dumps({k: round(v, 4) for k, v in worst.items()}),
          flush=True)
    for r in ranks:
        row = {k: r[k] for k in ("rank", "init_s", "param_bytes", "ttft_s", "decode_ms",
                                 "peak_bytes", "launches", "lost", "busy", "scans", "first_layer",
                                 "moe_exact", "moe_agreement", "routing_apart") if k in r}
        row["launches"] = {k: n for k, n in row["launches"].items() if n}
        row["logits_rel_l2_max"] = max(r["logits_rel_l2"].values())
        print(f"{cfg.name} P={MR_RANKS} rank {r['rank']} (gloo on one card; {smi}): "
              + json.dumps(row), flush=True)
    print(f"{cfg.name} P={MR_RANKS} cell: {time.perf_counter() - t_c:.1f}s", flush=True)
    return one, ranks


def report(path: str, impl: str, r: dict, sz: dict, gz: dict, g: dict, xz: dict,
           vz: dict, smi: str) -> None:
    """One JSON line of a path's end-to-end numbers, with the card."""
    label = "kernels" if impl == "auto" else "plain"
    if path == "hash-map path":
        n_ins = sz["wave"] * sz["waves"]
        line = dict(
            card=smi, insert_keys_per_s=n_ins / sum(r["insert_s"]),
            insert_wave_s=r["insert_s"],
            find_keys_per_s=sz["find"] / r["find_s"],
            find_insert_ops_per_s=2 * sz["fi"] / r["find_insert_s"],
            total_s=r["total_s"], peak_mem_bytes=r["peak_bytes"],
            count_ready=r["count"], launches=r["launches"])
    elif path == "extensions path":
        t = r["times"]
        n, fi = xz["n"], xz["fi"]
        line = dict(
            card=smi, corrupt_insert_keys_per_s=n / t["corrupt_insert_s"],
            lost=int((~r["ok1"]).sum()), healed=int(r["ok2"][~r["ok1"]].sum()),
            heal_keys_per_s=int((~r["ok1"]).sum()) / t["heal_s"],
            heal_lost=int((~r["ok1"] & ~r["ok2"]).sum()),
            heal_find_keys_per_s=n / t["heal_find_s"], unreachable=r["unreachable"],
            dense_insert_keys_per_s=n / t["dense_insert_s"],
            hier_insert_keys_per_s=n / t["hier_insert_s"],
            dense_find_keys_per_s=n / t["dense_find_s"],
            hier_find_keys_per_s=n / t["hier_find_s"],
            async_find_insert_ops_per_s=2 * fi / t["async_find_insert_s"],
            sync_find_insert_ops_per_s=2 * fi / t["sync_find_insert_s"],
            fault_launches=r["launches_faulty"], seconds=t, total_s=r["total_s"],
            peak_mem_bytes=r["peak_bytes"], launches=r["launches"])
    elif path == "dedup path":               # vz: the path's sizes
        n_sh = vz["seq_len"] - vz["ngram"] + 1
        n_obs, n_oap = vz["docs"] * vz["batches"], vz["docs"] + vz["probe"]
        line = dict(
            card=smi, documents=n_obs + n_oap + vz["planted"], shingles_per_document=n_sh,
            observe_docs_per_s=n_obs / sum(r["observe_s"]),
            observe_shingles_per_s=n_obs * n_sh / sum(r["observe_s"]),
            observe_batch_s=r["observe_s"],
            observe_and_probe_docs_per_s=n_oap / r["oap_s"],
            observe_and_probe_shingles_per_s=n_oap * n_sh / r["oap_s"],
            count_of_docs_per_s=vz["planted"] / r["count_s"],
            count_of_shingles_per_s=vz["planted"] * n_sh / r["count_s"],
            filter_fill=r["fill"], table_occupancy=r["occupancy"],
            excess_rate=r["excess_rate"], predicted_rate=r["predicted_rate"],
            final_model_rate=r["final_model_rate"],
            probe_excess_rate=r["probe_excess_rate"], count_off=r["count_off"],
            total_s=r["total_s"], peak_mem_bytes=r["peak_bytes"],
            launches={k: n for k, n in r["launches"].items() if n})
    elif path.startswith("f32 serve"):
        cfg = r["cfg"]
        line = dict(
            card=smi, arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
            requests=r["prompts"].shape[0], slots=r["batch"], prompt_len=r["prompts"].shape[1],
            gen=r["gen"], total_s=r["total_s"], peak_mem_bytes=r["peak_bytes"],
            rel_l2_max=r.get("rel_l2_max"), control_rel_l2_max=r.get("control_rel_l2_max"),
            launches={k: n for k, n in r["launches"].items() if n})
    elif "serving path" in path:            # vz: the path's sizes
        t = r["timings"]
        n_tok = vz["requests"] * vz["gen"]
        dec = sorted(t["decode_s"])
        serve_s = r.get("serve_s", r["total_s"])
        print(f"served {vz['requests']} requests, {n_tok} tokens in {serve_s:.2f}s "
              f"({n_tok / serve_s:.1f} tok/s)", flush=True)
        line = dict(
            card=smi, arch=vz["arch"], window_cache=r.get("window_cache"),
            requests=vz["requests"], slots=vz["batch"],
            prompt_len=vz["prompt_len"], frontend=vz.get("frontend"), gen=vz["gen"],
            prefill_tokens_per_s=[vz["batch"] * vz["prompt_len"] / x for x in t["prefill_s"]],
            ttft_s=t["prefill_s"], decode_ms_per_step_mean=1e3 * sum(dec) / len(dec),
            decode_ms_per_step_median=1e3 * dec[len(dec) // 2],
            decode_tokens_per_s=vz["batch"] * len(dec) / sum(dec),
            served_tokens_per_s=n_tok / r.get("serve_s", r["total_s"]), total_s=r["total_s"],
            peak_mem_bytes=r["peak_bytes"],
            launches={k: n for k, n in r["launches"].items() if n})
        for key, name in (("consistency", "prefill_decode_rel_l2"),
                          ("flipped_rows", "flipped_rows")):
            if key in r:
                line[name] = r[key]
    else:
        t = r["times"]
        line = dict(
            card=smi, genome_len=gz["genome_len"], kmers=g["n"], extensions=g["n_ext"],
            bloom_insert_kmers_per_s=g["n"] / t["bloom_insert_s"],
            bloom_find_keys_per_s=gz["probes"] / t["bloom_find_s"],
            count_kmers_per_s=g["n"] / t["count_s"],
            build_direct_keys_per_s=g["n_ext"] / t["build_direct_s"],
            build_buffered_keys_per_s=g["n_ext"] / t["build_buffered_s"],
            buffered_speedup=t["build_direct_s"] / t["build_buffered_s"],
            lookup_keys_per_s=2 * g["n_ext"] / t["lookup_s"],
            walk_steps_per_s=gz["walks"] * gz["steps"] / t["walk_s"],
            walked=r["walked"], bloom_fill=r["fill"],
            bloom_false_positive_share=float(
                r["present"][gz["probes"] // 2:].float().mean()),
            seconds=t, total_s=r["total_s"], peak_mem_bytes=r["peak_bytes"],
            launches=r["launches"])
    print(f"{path} ({label}): " + json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU with the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wire-split", action="store_true",
                    help="only build, capture the paths' calls and print the wire and "
                         "CSR splits")
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cpu" if rehearsal else "cuda")
    sz = REHEARSAL if rehearsal else FULL
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs reduce their split-K partial sums in float32, whatever the shape
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 1. the card
    smi = "" if rehearsal else nvidia_smi()
    kind = "cpu" if rehearsal else torch.cuda.get_device_name(0)
    count = 0 if rehearsal else torch.cuda.device_count()
    print(f"card: {smi} | {kind} | devices {count}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    if not rehearsal:
        t0 = time.perf_counter()
        took = build.build()
        print(f"build: {time.perf_counter() - t0:.1f}s total, per source "
              + json.dumps({k: round(v, 2) for k, v in took.items()}), flush=True)
        for src, log in build.BUILD_LOGS.items():
            for fn, info in ptxas_report(log).items():
                print(f"ptxas {src} {fn}: {info}", flush=True)
        f32_insts = fa.f32_instances()
        for route, insts in (("bf16", fa.bf16_instances()), ("f32", f32_insts)):
            for inst in insts:
                print(f"flash_attention {route} instance: " + json.dumps(inst), flush=True)
        f32_spills = [i for i in f32_insts if i["local_bytes"]]
        check(not f32_spills, f"flash_attention f32 instances spill nothing: {f32_spills}")
        sass = tensor_core_sass(build.BUILD_DIR / "libflash_attention.so", "flash_fwd_tf32")
        print("flash_attention f32 SASS tensor-core instructions by instance: "
              + json.dumps(sass) + f", total {sum(sass.values())}", flush=True)
        check(sum(sass.values()) > 0, "the float32 route runs tensor-core instructions")

    # 3. kernel phase at the paths' shapes
    gz = G_REHEARSAL if rehearsal else G_FULL
    data = workload(sz, dev, args.seed)
    gdata = genomics_workload(gz, dev, args.seed)
    print(f"genomics data: {gdata['n']} k-mers of {gz['k']} bases, "
          f"{gdata['uniq'].numel()} distinct, {gdata['n_ext']} solid extensions",
          flush=True)
    xz = X_REHEARSAL if rehearsal else X_FULL
    xdata = ext_workload(xz, dev, args.seed)
    calls = capture_calls(sz, data, gz, gdata, xz, xdata, dev)
    if args.wire_split:
        wire_split(calls, sz["reps"], dev, args.seed)
        csr_split(calls, sz["reps"], dev)
        return 0
    krows = kernel_phase(calls, sz["reps"], dev)
    wire_split(calls, sz["reps"], dev, args.seed)
    csr_split(calls, sz["reps"], dev)
    large_bins_case(sz, dev, args.seed)
    probe_split(calls, sz["reps"], dev)
    find_routes(sz, dev, args.seed)
    del calls
    frows = flash_phase(FLASH_REHEARSAL if rehearsal else FLASH_FULL, sz["reps"], dev,
                        args.seed)
    for name, case in FLASH_ROWS.items():
        krows[name] = frows[case]

    # 4.-10. each path: kernels, then plain versions
    vz = V_REHEARSAL if rehearsal else V_FULL
    launched = {}

    def run_path(path, drive, oracle, same, used, sizes=None):
        runs = {}
        for impl in ("auto", "torch"):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t0 = time.perf_counter()
            r = drive(impl, runs)
            sync(dev)
            r["total_s"] = time.perf_counter() - t0
            r["launches"] = build.launch_counts()
            r["peak_bytes"] = (torch.cuda.max_memory_allocated()
                               if dev.type == "cuda" else None)
            runs[impl] = r
            launched[path, impl] = r["launches"]
        for impl in ("auto", "torch"):
            oracle(runs[impl])
        same(runs["auto"], runs["torch"])
        if not rehearsal:
            counts = runs["auto"]["launches"]
            check(all(counts[name] > 0 for name in used),
                  f"every kernel of the {path} ran: {counts}")
        check(all(n == 0 for n in runs["torch"]["launches"].values()),
              f"the plain run of the {path} launched no kernel: {runs['torch']['launches']}")
        for impl in ("auto", "torch"):
            report(path, impl, runs[impl], sz, gz, gdata, xz, sizes or vz, smi)
        return runs

    run_path("hash-map path", lambda impl, _: main_path(impl, sz, data, dev),
             lambda r: check_oracle(r, data, sz), same_results, HASHMAP_KERNELS)
    run_path("genomics path", lambda impl, _: genomics_path(impl, gz, gdata, dev),
             lambda r: check_genomics(r, gdata, gz), same_genomics, GENOMICS_KERNELS)
    run_path("extensions path", lambda impl, _: ext_path(impl, xz, xdata, dev),
             lambda r: check_ext(r, xdata, xz), same_ext, EXT_KERNELS)
    del data, xdata
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 7. the dedup path: the corpus and the oracle's facts first (host and
    # card, outside every timed region), then the Deduper with the kernels
    # and with the plain versions
    dz = D_REHEARSAL if rehearsal else D_FULL
    t0 = time.perf_counter()
    corpus = dedup_corpus(dz, args.seed)
    t1 = time.perf_counter()
    oracle = dedup_oracle(dz, corpus, dev)
    sync(dev)
    print(f"dedup corpus: {dz['batches']} batches of {dz['docs']} documents of "
          f"{dz['seq_len']} tokens ({len(corpus['copies'])} verbatim copies), a fresh batch, "
          f"a probe of {dz['probe']}, {dz['planted']} planted copies; made in "
          f"{t1 - t0:.1f}s on the host; oracle over {oracle['shingles']} ingested shingles "
          f"({oracle['uniq'].numel()} distinct) in {time.perf_counter() - t1:.1f}s",
          flush=True)
    dd = {k: v if k == "copies" else
          [torch.from_numpy(b).to(dev) for b in v] if k == "batches" else
          torch.from_numpy(v).to(dev) for k, v in corpus.items()}
    del corpus
    druns = run_path("dedup path", lambda impl, _: dedup_path(impl, dz, dd, dev),
                     lambda r: check_dedup(r, dz, dd, oracle), same_dedup, DEDUP_KERNELS,
                     sizes=dz)
    if not rehearsal:
        counts = {k: n for k, n in launched["dedup path", "auto"].items() if n}
        check(set(counts) == set(DEDUP_KERNELS),
              f"dedup path: launches exactly {sorted(DEDUP_KERNELS)}: {counts}")
        dedup_split(druns["auto"], dd)
    del druns, dd, oracle
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 8. the serving paths: the plain run is fed the kernel run's tokens
    def forced(runs):
        toks = runs["auto"]["tokens"]
        return torch.tensor([toks[i] for i in range(len(toks))], device=dev)

    def serving_cell(path, vz_, sv_, feed=None, same=same_serving):
        """``serve`` with the kernels (fed ``feed`` if given) and with the
        plain versions; on the card the bf16 flash route must run once
        per attention layer and wave, each mixer's scan once per layer and
        call, and no other kernel."""
        n_waves = -(-vz_["requests"] // vz_["batch"])
        want = serving_launches(sv_["cfg"], n_waves, vz_["gen"], vz_["prompt_len"])
        runs = run_path(path, lambda impl, runs: serving_path(
            impl, vz_, sv_, feed if impl == "auto" else forced(runs)),
            lambda r: check_serving(r, vz_, sv_), lambda a, b: same(a, b, vz_, sv_),
            tuple(want), sizes=vz_)
        if not rehearsal:
            counts = {k: n for k, n in launched[path, "auto"].items() if n}
            check(counts == want, f"{path}: the bf16 flash_attention route once per attention "
                                  f"layer and wave, the scans once per mixer layer and call, no "
                                  f"other kernel (flash_attention_f32 included): want {want}, "
                                  f"got {counts}")
        return runs

    sv = serving_setup(vz, dev, args.seed)
    serving_cell("serving path", vz, sv)
    del sv
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 8b. the windowed serving path: gemma3-4b, window_cache off, then on (its
    # kernel run fed the first run's tokens, so every step's logits compare)
    wz = W_REHEARSAL if rehearsal else W_FULL
    wv = serving_setup(wz, dev, args.seed)
    off = serving_cell(f"{wz['arch']} serving path", wz, wv)
    wv_ring = dict(wv, cfg=dataclasses.replace(wv["cfg"], window_cache=True),
                   label=f"{wz['arch']} serving, window_cache")
    ring = serving_cell(f"{wz['arch']} serving path, window_cache", wz, wv_ring,
                        feed=forced(off))
    same_window_cache(off["auto"], ring["auto"], wv)
    ring_decode_check(wv, wz, off["auto"]["tokens"])
    del wv, wv_ring, off, ring
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 9. the MoE serving path: the wire kernels at its shapes, then serve
    # (the plain run fed the kernel run's tokens), then its device split
    mz = M_REHEARSAL if rehearsal else M_FULL
    mv = moe_setup(mz, dev, args.seed)
    mrows = moe_wire_phase(mz, mv, sz["reps"], dev)
    run_path("MoE serving path",
             lambda impl, runs: moe_serving_path(impl, mz, mv,
                                                 None if impl == "auto" else forced(runs)),
             lambda r: check_moe_serving(r, mz, mv),
             lambda a, b: same_moe_serving(a, b, mz, mv), MOE_KERNELS, sizes=mz)
    m_waves = -(-mz["requests"] // mz["batch"])
    if not rehearsal:
        counts = {k: n for k, n in launched["MoE serving path", "auto"].items() if n}
        want = moe_wire_launches(mv["cfg"], m_waves * (mz["gen"] + 1))
        want["flash_attention"] = mz["layers"] * m_waves
        check(counts == want, f"MoE serving path: launches {counts}, want {want}")
        moe_split(mz, mv)
    print("MoE wire rows: " + json.dumps({k: {f: v[f] for f in ("ms", "bound_ms")}
                                          for k, v in mrows.items()}), flush=True)
    del mv
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 9b. the deepseek-v3 serving path: the wire kernels at its shapes, then
    # serve with mla_absorb off and on (the second's kernel run fed the first's
    # tokens), the first layer's decode forms, and the device split
    t_ds = time.perf_counter()
    dz = DS_REHEARSAL if rehearsal else DS_FULL
    dv = ds_setup(dz, dev, args.seed)
    dsrows = moe_wire_phase(dz, dv, sz["reps"], dev)
    ds_waves = -(-dz["requests"] // dz["batch"])
    ds_runs = {}
    for absorb in (False, True):
        dv_ = dv if not absorb else dict(
            dv, cfg=dataclasses.replace(dv["cfg"], mla_absorb=True),
            label=f"{dv['cfg'].name} serving, mla_absorb")
        path = "deepseek serving path" + (", mla_absorb" if absorb else "")
        feed = forced(ds_runs[False]) if absorb else None
        ds_runs[absorb] = run_path(
            path, lambda impl, runs, dv_=dv_, feed=feed: moe_serving_path(
                impl, dz, dv_, feed if impl == "auto" else forced(runs)),
            lambda r, dv_=dv_: check_moe_serving(r, dz, dv_),
            lambda a, b, dv_=dv_: same_deepseek_serving(a, b, dz, dv_), MOE_KERNELS, sizes=dz)
        if not rehearsal:
            counts = {k: n for k, n in launched[path, "auto"].items() if n}
            want = moe_wire_launches(dv_["cfg"], ds_waves * (dz["gen"] + 1))
            want["flash_attention"] = dz["layers"] * ds_waves
            check(counts == want, f"{path}: launches {counts}, want {want}")
    same_mla_absorb(ds_runs[False]["auto"], ds_runs[True]["auto"], dv)
    mla_decode_check(dv, dz, ds_runs[False]["auto"]["tokens"])
    if not rehearsal:
        for absorb in (False, True):
            ds_split(dz, dv, absorb)
    print("deepseek wire rows: " + json.dumps({k: {f: v[f] for f in ("ms", "bound_ms")}
                                               for k, v in dsrows.items()}), flush=True)
    print(f"deepseek cell: {time.perf_counter() - t_ds:.1f}s", flush=True)
    del dv, dv_, ds_runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 9c. the recurrent serving cells: serve (the plain run fed the kernel run's
    # tokens; decode vs prefill of the same tokens holds the state carry), the
    # first mixer layer's scan calls held and timed, then the device split
    for cz in SSM_REHEARSAL if rehearsal else SSM_FULL:
        t_c = time.perf_counter()
        cv = ssm_setup(cz, dev, args.seed)
        serving_cell(f"{cz['arch']} serving path", cz, cv, same=same_logits)
        name, calls = scan_calls(cv, cz)
        krows.update(scan_check(name, calls, sz["reps"], dev))
        del calls
        if not rehearsal:
            ssm_split(cz, cv)
        print(f"{cz['arch']} cell: {time.perf_counter() - t_c:.1f}s", flush=True)
        del cv
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # 9d. the frontend cells: serve with each request's embeddings (the plain run
    # fed the kernel run's tokens), the first attention calls kernel vs plain and
    # the decode check with its planted faults, then the device split
    for fz in FRONTEND_REHEARSAL if rehearsal else FRONTEND_FULL:
        t_c = time.perf_counter()
        fv = frontend_setup(fz, dev, args.seed)
        fz = dict(fz, prompt_len=fv["prompts"].shape[1],
                  frontend={k: e.shape[1] for k, e in fv["embeds"].items()})
        serving_cell(f"{fz['arch']} serving path", fz, fv, same=same_frontend)
        if not rehearsal:
            frontend_split(fz, fv)
        print(f"{fz['arch']} cell: {time.perf_counter() - t_c:.1f}s", flush=True)
        del fv
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # 10. the float32 serve phase: serve.py's main, plain run teacher-forced
    for arch in F32_SERVE_ARCHS:
        run_path(f"f32 serve {arch}",
                 lambda impl, runs, arch=arch: f32_serve_path(impl, arch, runs, dev),
                 check_f32_serve, lambda a, b: same_f32_serve(a, b, dev),
                 tuple(serving_launches(reduced(get_config(arch)), 1, 1, F32_SERVE_PROMPT_LEN)))

    # 11. the multi-rank cells: the one-rank reference here, then four gloo
    # ranks on the one card; each rank's launches count with the paths'
    for mz in MR_REHEARSAL if rehearsal else MR_FULL:
        one, ranks = multirank_cell(mz, dev, args.seed, smi, rehearsal)
        launched[f"{mz['arch']} P={MR_RANKS}, one-rank reference", "auto"] = one["launches"]
        for r in ranks:
            launched[f"{mz['arch']} P={MR_RANKS} rank {r['rank']}", "auto"] = r["launches"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # launches: the paths' kernel runs (each path's counts are printed above)
    paths = sorted({p for p, _ in launched})
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(launched[p, "auto"][name] for p in paths),
                    **{k: v for k, v in krows[name].items() if k not in ROW_DETAIL})
               for name, (_m, _w, _p, src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    if rehearsal:
        print("chip_smoke: CPU rehearsal passed (no device result)")
        return 0
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
