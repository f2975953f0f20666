"""Voice activity detection on the device (port of models/vad.py).

Two detectors, as in the reference:

1. :class:`PyanNet` — pyannote.audio's PyanNet segmentation model
   (SincNet band-pass frontend -> stacked BiLSTM -> leaky-ReLU linear
   stack -> sigmoid frame probabilities) as an ``nn.Module``, loaded from
   a pyannote-layout state dict (:func:`convert_pyannet`) or from the
   JAX package's param tree (:func:`params_from_jax`). It runs as
   fixed 5 s / 2.5 s sliding windows formed on the device from one
   upload of the channel (:func:`pyannet_windowed_dispatch`), with the
   overlap averaged on the host (:func:`pyannet_windowed_fetch`).
2. :func:`energy_vad_probs` — the deterministic energy detector used
   when no checkpoint is configured.

Both emit frame speech probabilities; :func:`binarize` (numpy) applies
pyannote-style onset/offset hysteresis with min-duration filtering.

The forward runs in true fp32, as the reference's does: cuDNN would run
the fp32 convolutions and the LSTM in TF32 by default, so the forward on
a CUDA device turns cuDNN's TF32 off while it enqueues its work, and
refuses to run when fp32 matmuls are set to TF32 (as the frontends do).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.dsp.stft import frame_signal, require_true_fp32
from audio_processor_tpu_torch.io.wire import maybe_int16_wire, upload


# ----------------------------------------------------------------------
# PyanNet-style model
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PyanNetConfig:
    """Geometry of pyannote.audio's PyanNet segmentation model
    (pyannote SincNet + monolithic BiLSTM + leaky-ReLU linear stack;
    defaults match pyannote's LSTM_DEFAULTS / LINEAR_DEFAULTS)."""

    sample_rate: int = 16000
    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_channels: int = 60
    conv_kernel: int = 5
    pool: int = 3
    lstm_hidden: int = 128
    lstm_layers: int = 2
    linear_hidden: int = 128
    linear_layers: int = 2
    num_outputs: int = 1
    leaky_slope: float = 0.01   # F.leaky_relu default


def sinc_filters(low_hz: torch.Tensor, band_hz: torch.Tensor,
                 kernel: int, sample_rate: int) -> torch.Tensor:
    """SincNet band-pass bank [F, kernel] from learnable cutoffs
    (``torch.sinc`` is the normalised sinc, as ``jnp.sinc``)."""
    min_low, min_band = 50.0, 50.0
    low = min_low + low_hz.abs()
    high = torch.clamp(low + min_band + band_hz.abs(), min_low,
                       sample_rate / 2)
    t = (torch.arange(kernel, dtype=torch.float32, device=low.device)
         - (kernel - 1) / 2) / sample_rate                    # seconds
    # Built on the device (in float64, as the reference's numpy window):
    # a blocking host copy here would sync the stream on every forward.
    window = torch.hamming_window(kernel, periodic=False,
                                  dtype=torch.float64,
                                  device=low.device).float()
    f1, f2 = low[:, None], high[:, None]
    filt = (2 * f2 * torch.sinc(2 * f2 * t)
            - 2 * f1 * torch.sinc(2 * f1 * t)) * window      # [F, K]
    # normalize each filter to unit peak (SincNet convention)
    return filt / (2.0 * (high - low))[:, None]


@contextlib.contextmanager
def _true_fp32(device: torch.device):
    """fp32 stays fp32 on a CUDA device: refuse TF32 matmuls, and turn
    cuDNN's TF32 (convolutions, LSTM) off while the work is enqueued.
    The flag is process-wide; the rest of the port runs no fp32 cuDNN
    work that it would change (bf16 encoder, float64 fp32 convs)."""
    if device.type != "cuda":
        yield
        return
    require_true_fp32(device)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Norm(nn.Module):
    """Affine per-sample per-channel normalization over time of [B, C, T]
    with the population variance (torch InstanceNorm1d(affine=True))."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=2, keepdim=True)
        var = x.var(dim=2, keepdim=True, unbiased=False)
        return ((x - mean) * torch.rsqrt(var + self.eps)
                * self.weight[:, None] + self.bias[:, None])


class _Sinc(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.low_hz = nn.Parameter(torch.zeros(filters))
        self.band_hz = nn.Parameter(torch.zeros(filters))


class PyanNet(nn.Module):
    """[B, T] waveform (fp32, or int16 on the wire) -> [B, frames]
    speech probabilities.

    pyannote.audio's PyanNet forward: per SincNet block conv -> abs
    (sinc block only) -> maxpool -> affine InstanceNorm -> leaky_relu;
    monolithic BiLSTM; leaky_relu linear stack; sigmoid classifier, max
    over outputs (multi-speaker segmentation checkpoints; the VAD
    pipeline's reduction). Parameter names follow the JAX param tree;
    the LSTM's single bias of the reference sits in ``bias_ih`` with
    ``bias_hh`` zero."""

    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        self.cfg = cfg
        Fs, C, H = cfg.sinc_filters, cfg.conv_channels, cfg.lstm_hidden
        self.wav_norm = _Norm(1)
        self.sinc = _Sinc(Fs)
        self.norm0 = _Norm(Fs)
        self.conv1 = nn.Conv1d(Fs, C, cfg.conv_kernel)
        self.norm1 = _Norm(C)
        self.conv2 = nn.Conv1d(C, C, cfg.conv_kernel)
        self.norm2 = _Norm(C)
        self.lstm = nn.LSTM(C, H, num_layers=cfg.lstm_layers,
                            batch_first=True, bidirectional=True)
        d, linear = 2 * H, []
        for _ in range(cfg.linear_layers):
            linear.append(nn.Linear(d, cfg.linear_hidden))
            d = cfg.linear_hidden
        self.linear = nn.ModuleList(linear)
        self.classifier = nn.Linear(d, cfg.num_outputs)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        with _true_fp32(waveform.device):
            return self._forward(waveform)

    def _forward(self, waveform: torch.Tensor) -> torch.Tensor:
        cfg, slope = self.cfg, self.cfg.leaky_slope
        if waveform.dtype == torch.int16:
            # k / 2^15 is exact in fp32: bit-identical to an f32 upload.
            waveform = waveform.float() * (1.0 / 32768.0)
        x = self.wav_norm(waveform[:, None, :])                # [B, 1, T]
        filt = sinc_filters(self.sinc.low_hz, self.sinc.band_hz,
                            cfg.sinc_kernel, cfg.sample_rate)  # [F, K]
        x = F.conv1d(x, filt[:, None, :], stride=cfg.sinc_stride)
        x = F.max_pool1d(x.abs(), cfg.pool)                    # VALID
        x = F.leaky_relu(self.norm0(x), slope)
        for conv, norm in ((self.conv1, self.norm1),
                           (self.conv2, self.norm2)):
            x = F.max_pool1d(conv(x), cfg.pool)
            x = F.leaky_relu(norm(x), slope)
        x, _ = self.lstm(x.transpose(1, 2))                    # [B, T', 2H]
        for lin in self.linear:
            x = F.leaky_relu(lin(x), slope)
        probs = torch.sigmoid(self.classifier(x))
        return probs.max(dim=-1).values


def pyannet_frame_hop_sec(cfg: PyanNetConfig) -> float:
    """Seconds per output frame (stride 10 x three pools of 3)."""
    return cfg.sinc_stride * cfg.pool ** 3 / cfg.sample_rate


def pyannet_frame_hop_samples(cfg: PyanNetConfig) -> int:
    return cfg.sinc_stride * cfg.pool ** 3


def pyannet_num_frames(cfg: PyanNetConfig, samples: int) -> int:
    """Output frame count of PyanNet for an input length (valid convs/
    pools: sinc k251 s10, then 3x [pool3 + conv k5 except after the last
    pool])."""
    t = (samples - cfg.sinc_kernel) // cfg.sinc_stride + 1
    t = t // cfg.pool
    t = t - (cfg.conv_kernel - 1)
    t = t // cfg.pool
    t = t - (cfg.conv_kernel - 1)
    t = t // cfg.pool
    return max(0, t)


@torch.inference_mode()
def pyannet_windowed_dispatch(model: PyanNet, mono: np.ndarray,
                              window_sec: float = 5.0,
                              step_sec: float = 2.5,
                              batch_rows: int = 16,
                              int16_wire: bool = None):
    """Upload one channel and enqueue its sliding-window VAD sub-batches
    on the model's device WITHOUT syncing. Returns an opaque pending
    handle for :func:`pyannet_windowed_fetch`.

    The channel is uploaded once (int16 when every sample is int16-exact;
    ``int16_wire``: None = engage iff exact, False = never); the windows
    are a strided view of it (``Tensor.unfold``), so the ~2x overlap of
    the 5 s / 2.5 s regime costs no upload bytes. The buffer is
    zero-padded so every sub-batch is full; rows beyond the last window
    are cropped at fetch. An error in the device work surfaces at fetch.
    """
    cfg = model.cfg
    device = model.classifier.weight.device
    sr = cfg.sample_rate
    hop = pyannet_frame_hop_samples(cfg)
    W = int(window_sec * sr)
    S = max(hop, int(step_sec * sr) // hop * hop)
    x = np.asarray(mono, np.float32).reshape(-1)
    T = x.shape[0]
    n_win = max(1, -(-(max(T - W, 0)) // S) + 1)
    n_batches = -(-n_win // batch_rows)
    L = (n_batches * batch_rows - 1) * S + W
    if L > T:
        x = np.concatenate([x, np.zeros(L - T, np.float32)])
    if int16_wire is None or int16_wire:
        x = maybe_int16_wire(x)
    rows = upload(x, device).unfold(0, W, S)       # [n_batches*rows, W]
    outs = [model(rows[g * batch_rows:(g + 1) * batch_rows])
            for g in range(n_batches)]
    return outs, {"cfg": cfg, "n_win": n_win, "T": T, "S": S,
                  "W": W, "hop": hop}


def pyannet_windowed_fetch(pending) -> np.ndarray:
    """Fetch + overlap-average a :func:`pyannet_windowed_dispatch`
    handle into [frames] speech probabilities."""
    outs, m = pending
    cfg, n_win, T, S, W, hop = (m["cfg"], m["n_win"], m["T"], m["S"],
                                m["W"], m["hop"])
    F_w = pyannet_num_frames(cfg, W)
    probs = np.concatenate([o.cpu().numpy()[:, :F_w] for o in outs])[:n_win]

    # Overlap-average onto the absolute frame grid (window w's frame
    # f sits at absolute frame w*(S//hop) + f).
    step_frames = S // hop
    padded_len = (n_win - 1) * S + W
    n_total = pyannet_num_frames(cfg, padded_len)
    sums = np.zeros(n_total, np.float64)
    counts = np.zeros(n_total, np.float64)
    for w in range(n_win):
        lo = w * step_frames
        hi = min(lo + F_w, n_total)
        sums[lo:hi] += probs[w, :hi - lo]
        counts[lo:hi] += 1.0
    agg = (sums / np.maximum(counts, 1.0)).astype(np.float32)
    # Trim frames whose hop position lies entirely in the zero tail
    # (the pyannote pipeline crops its timeline to the file duration).
    n_keep = max(1, min(agg.shape[0], -(-T // hop)))
    return agg[:n_keep]


def pyannet_probs_windowed(model: PyanNet, mono: np.ndarray,
                           window_sec: float = 5.0,
                           step_sec: float = 2.5,
                           batch_rows: int = 16,
                           int16_wire: bool = None) -> np.ndarray:
    """Arbitrary-length mono waveform -> [frames] speech probabilities
    via fixed-size sliding windows, batched, with overlap averaging —
    the inference regime of the reference's pyannote pipeline
    (Inference('sliding')). The step is snapped DOWN to the model's
    output frame hop (270 samples) so every window's frame grid aligns
    with the absolute grid; the tail window is zero-padded."""
    return pyannet_windowed_fetch(pyannet_windowed_dispatch(
        model, mono, window_sec=window_sec, step_sec=step_sec,
        batch_rows=batch_rows, int16_wire=int16_wire))


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, np.float32))


def _lstm_entries(layer: int, suffix: str, w_ih, w_hh, b) -> Dict:
    """One LSTM direction under nn.LSTM's names: the reference's single
    bias in ``bias_ih``, ``bias_hh`` zero."""
    b = _f32(b)
    return {f"lstm.weight_ih_l{layer}{suffix}": _f32(w_ih),
            f"lstm.weight_hh_l{layer}{suffix}": _f32(w_hh),
            f"lstm.bias_ih_l{layer}{suffix}": b,
            f"lstm.bias_hh_l{layer}{suffix}": torch.zeros_like(b)}


def convert_pyannet(state_dict: Dict[str, Any],
                    cfg: PyanNetConfig) -> Dict[str, torch.Tensor]:
    """pyannote.audio PyanNet torch state dict -> a state dict of
    :class:`PyanNet`.

    Layout per pyannote.audio models.segmentation.PyanNet: sincnet
    (wav_norm1d, conv1d.0.filterbank.low_hz_/band_hz_ [asteroid
    Encoder(ParamSincFB)], conv1d.{1,2} with biases, norm1d.{0,1,2}
    affine InstanceNorms), lstm.* (weight_ih_l{k}[_reverse] ...),
    linear.{k}, classifier. The two LSTM biases are summed into
    ``bias_ih``, as the reference sums them into its one bias."""
    def first(*keys):
        for k in keys:
            if k in state_dict:
                return _f32(state_dict[k])
        raise KeyError(keys[0])

    out: Dict[str, torch.Tensor] = {
        "wav_norm.weight": _f32(state_dict["sincnet.wav_norm1d.weight"]),
        "wav_norm.bias": _f32(state_dict["sincnet.wav_norm1d.bias"]),
        "sinc.low_hz": first("sincnet.conv1d.0.filterbank.low_hz_",
                             "sincnet.conv1d.0.low_hz_").reshape(-1),
        "sinc.band_hz": first("sincnet.conv1d.0.filterbank.band_hz_",
                              "sincnet.conv1d.0.band_hz_").reshape(-1),
    }
    for i in range(3):
        for p in ("weight", "bias"):
            out[f"norm{i}.{p}"] = _f32(state_dict[f"sincnet.norm1d.{i}.{p}"])
    for i in (1, 2):
        for p in ("weight", "bias"):
            out[f"conv{i}.{p}"] = _f32(state_dict[f"sincnet.conv1d.{i}.{p}"])
    for layer in range(cfg.lstm_layers):
        for suffix in ("", "_reverse"):
            out.update(_lstm_entries(
                layer, suffix,
                state_dict[f"lstm.weight_ih_l{layer}{suffix}"],
                state_dict[f"lstm.weight_hh_l{layer}{suffix}"],
                _f32(state_dict[f"lstm.bias_ih_l{layer}{suffix}"])
                + _f32(state_dict[f"lstm.bias_hh_l{layer}{suffix}"])))
    i = 0
    while f"linear.{i}.weight" in state_dict:
        for p in ("weight", "bias"):
            out[f"linear.{i}.{p}"] = _f32(state_dict[f"linear.{i}.{p}"])
        i += 1
    for p in ("weight", "bias"):
        out[f"classifier.{p}"] = _f32(state_dict[f"classifier.{p}"])
    return out


def synthetic_pyannote_state_dict(seed: int, num_outputs: int = 3) -> dict:
    """A PyanNet state dict in pyannote.audio's key layout at its default
    geometry (SincNet 80 filters, convs 60, 2-layer BiLSTM 128, linear
    128 x 2), seeded. The classifier is scaled up (x30, bias -1) so the
    random network's frame probabilities spread around 0.5 instead of
    sitting at it: the VAD then finds speech on most frames, with gaps."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale):
        return scale * torch.randn(*shape, generator=g)

    sd = {"sincnet.wav_norm1d.weight": 1 + n(1, scale=0.1),
          "sincnet.wav_norm1d.bias": n(1, scale=0.1),
          "sincnet.conv1d.0.filterbank.low_hz_":
              torch.linspace(30.0, 6000.0, 80)[:, None],
          "sincnet.conv1d.0.filterbank.band_hz_":
              torch.linspace(80.0, 400.0, 80)[:, None]}
    for i, (c_in, c_out) in ((1, (80, 60)), (2, (60, 60))):
        sd[f"sincnet.conv1d.{i}.weight"] = n(c_out, c_in, 5,
                                             scale=(5 * c_in) ** -0.5)
        sd[f"sincnet.conv1d.{i}.bias"] = n(c_out, scale=0.1)
    for i, c in enumerate((80, 60, 60)):
        sd[f"sincnet.norm1d.{i}.weight"] = 1 + n(c, scale=0.1)
        sd[f"sincnet.norm1d.{i}.bias"] = n(c, scale=0.1)
    for layer, c_in in ((0, 60), (1, 256)):
        for sfx in ("", "_reverse"):
            sd[f"lstm.weight_ih_l{layer}{sfx}"] = n(512, c_in,
                                                    scale=c_in ** -0.5)
            sd[f"lstm.weight_hh_l{layer}{sfx}"] = n(512, 128,
                                                    scale=128 ** -0.5)
            sd[f"lstm.bias_ih_l{layer}{sfx}"] = n(512, scale=0.1)
            sd[f"lstm.bias_hh_l{layer}{sfx}"] = n(512, scale=0.1)
    for i, c_in in enumerate((256, 128)):
        sd[f"linear.{i}.weight"] = n(128, c_in, scale=c_in ** -0.5)
        sd[f"linear.{i}.bias"] = n(128, scale=0.1)
    sd["classifier.weight"] = n(num_outputs, 128, scale=30 * 128 ** -0.5)
    sd["classifier.bias"] = torch.full((num_outputs,), -1.0)
    return sd


def params_from_jax(params_np: Dict[str, Any], cfg: PyanNetConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX param tree (``init_pyannet`` or ``convert_pyannet``;
    leaves as numpy arrays) -> a state dict of :class:`PyanNet`:
    ``kernel [in, out]`` -> ``weight [out, in]``, conv ``kernel [K, in,
    out]`` -> ``weight [out, in, K]``, norm ``scale`` -> ``weight``, the
    LSTM's ``w_ih``/``w_hh`` transposed with ``b`` in ``bias_ih``."""
    p = params_np

    def T(x):
        return np.asarray(x).T

    out: Dict[str, torch.Tensor] = {
        "sinc.low_hz": _f32(p["sinc"]["low_hz"]),
        "sinc.band_hz": _f32(p["sinc"]["band_hz"]),
    }
    for name in ("wav_norm", "norm0", "norm1", "norm2"):
        out[f"{name}.weight"] = _f32(p[name]["scale"])
        out[f"{name}.bias"] = _f32(p[name]["bias"])
    for name in ("conv1", "conv2"):
        out[f"{name}.weight"] = _f32(
            np.asarray(p[name]["kernel"]).transpose(2, 1, 0))
        out[f"{name}.bias"] = _f32(p[name]["bias"])
    for layer, entry in enumerate(p["lstm"]):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            d = entry[direction]
            out.update(_lstm_entries(layer, suffix, T(d["w_ih"]),
                                     T(d["w_hh"]), d["b"]))
    for i, lin in enumerate(p["linear"]):
        out[f"linear.{i}.weight"] = _f32(T(lin["kernel"]))
        out[f"linear.{i}.bias"] = _f32(lin["bias"])
    out["classifier.weight"] = _f32(T(p["classifier"]["kernel"]))
    out["classifier.bias"] = _f32(p["classifier"]["bias"])
    return out


# ----------------------------------------------------------------------
# Energy VAD fallback
# ----------------------------------------------------------------------

FRAME = 400   # 25 ms @ 16 kHz
HOP = 160     # 10 ms


@torch.inference_mode()
def energy_vad_probs(waveform: torch.Tensor, lengths: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] -> ([B, F] speech probabilities, [B, F] frame mask).

    Deterministic adaptive-threshold RMS detector: a frame is speech
    when its RMS exceeds max(1e-4, 0.1 * p95-RMS of the utterance). The
    p95 is taken over the masked RMS row with its zeros (linear
    interpolation, ``jnp.percentile``'s default), as the reference does.
    """
    B, T = waveform.shape
    nf = max(0, 1 + (T - FRAME) // HOP)
    dev = waveform.device
    if nf == 0:
        return (torch.zeros(B, 0, device=dev),
                torch.zeros(B, 0, dtype=torch.bool, device=dev))
    frames = frame_signal(waveform.float(), FRAME, HOP, nf)
    rms = torch.sqrt(torch.mean(frames * frames, dim=-1))     # [B, F]
    valid = torch.clamp(1 + (lengths.to(dev).long() - FRAME) // HOP, min=0)
    mask = torch.arange(nf, device=dev)[None, :] < valid[:, None]
    rms_m = torch.where(mask, rms, 0.0)
    p95 = torch.quantile(rms_m, 0.95, dim=-1, keepdim=True,
                         interpolation="linear")
    thresh = torch.clamp(0.1 * p95, min=1e-4)
    probs = torch.sigmoid((rms - thresh) / (0.1 * thresh + 1e-8))
    return torch.where(mask, probs, 0.0), mask


# ----------------------------------------------------------------------
# Binarization (pyannote-style hysteresis)
# ----------------------------------------------------------------------

def binarize(probs: np.ndarray, frame_hop_sec: float,
             onset: float = 0.5, offset: float = 0.5,
             min_duration_on: float = 0.0,
             min_duration_off: float = 0.0) -> List[Tuple[float, float]]:
    """Frame probabilities -> [(start_sec, end_sec)] speech regions.

    Vectorized hysteresis: the per-frame state machine (activate on
    p > onset, deactivate on p < offset) is a forward-fill of the
    last decisive frame's sign."""
    probs = np.asarray(probs).reshape(-1)
    n = probs.shape[0]
    segments: List[Tuple[float, float]] = []
    if n:
        if onset < offset:
            # Inverted "hysteresis" band: a p in (onset, offset)
            # satisfies BOTH transitions, so the state machine
            # toggles every frame — no forward-fill equivalent
            # exists. Run the exact per-frame machine for this
            # (misconfigured but legal) regime.
            active = np.empty(n, dtype=bool)
            act = False
            for i, p in enumerate(probs):
                if not act and p > onset:
                    act = True
                elif act and p < offset:
                    act = False
                active[i] = act
        else:
            sig = np.where(probs > onset, 1,
                           np.where(probs < offset, -1, 0)).astype(np.int8)
            last = np.maximum.accumulate(
                np.where(sig != 0, np.arange(n), -1))
            active = np.where(last >= 0,
                              sig[np.maximum(last, 0)] == 1, False)
        prev = np.concatenate(([False], active[:-1]))
        starts = np.nonzero(active & ~prev)[0]
        ends = np.nonzero(~active & prev)[0]
        for k, s in enumerate(starts):
            e = ends[k] if k < ends.shape[0] else n
            segments.append((s * frame_hop_sec, e * frame_hop_sec))

    if min_duration_off > 0 and segments:
        merged = [list(segments[0])]
        for s, e in segments[1:]:
            if s - merged[-1][1] < min_duration_off:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        segments = [tuple(x) for x in merged]
    if min_duration_on > 0:
        segments = [(s, e) for s, e in segments if e - s >= min_duration_on]
    return segments
