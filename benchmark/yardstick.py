"""The benchmark's arithmetic: the work a cell's calls and steps must do,
counted from the U-Net configuration's shapes alone, and the card's
data-sheet peaks. Whatever implements the model, these counts stay.

- ``unet_conv_flops``: the forward's conv FLOPs of one finger image (2 a
  multiply-add), every conv of the graph, float or int8.
- ``int8_sites``: the int8 PTQ scheme's quantized convs (every DoubleConv
  conv but the first one's; the transposed convs, the 1x1 head and
  ``inc/conv1`` stay float), with what each reads and writes: its int8
  input (at ``up_j/conv1`` the skip and the unpadded upconv output), its
  int8 weights, and one output a consumer, int8 at a quantized consumer's
  scale and 2 bytes (bfloat16) where a float op reads it. An encoder
  ``conv2`` above the bottom has two consumers: the skip, at its decoder
  conv's scale, and the max-pool, at the next level's.
- ``conv_int8_bound_ms``: the least time the card could take for a site,
  the larger of its int8 operations at the int8 peak and its bytes at the
  memory bandwidth, summed over the sites.
- ``preprocess_bytes``: what the front end reads and writes (the frames,
  the base frame, the float32 network input).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

# NVIDIA's data sheets, dense rates: (name substring, memory bytes/s,
# bfloat16 tensor-core FLOP/s, int8 tensor-core OP/s). The first key that
# the card's name holds wins, so the plain "H100" (the SXM part) is last.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 1513e12),
    ("H100 NVL", 3.9e12, 835e12, 1671e12),
    ("H200", 4.8e12, 989e12, 1979e12),
    ("H100", 3.35e12, 989e12, 1979e12),
)


class Peaks(NamedTuple):
    bytes_per_s: float
    bf16_flops: float
    int8_ops: float

    def compute(self, precision: str) -> float:
        """The peak of a configuration's precision: its int8 graph's few
        float convs are counted at the int8 peak too."""
        return {"bf16": self.bf16_flops, "int8": self.int8_ops}[precision]


def card_peaks(name: str) -> Peaks:
    for key, bw, bf16, int8 in CARD_PEAKS:
        if key in name:
            return Peaks(bw, bf16, int8)
    raise KeyError(f"no data-sheet peaks for the card {name!r}")


def _conv_out(h: int, w: int, k: int) -> Tuple[int, int]:
    """A padding-1 conv's output size (the reference pads 1 for any k)."""
    return h + 3 - k, w + 3 - k


def unet_conv_flops(cfg: dict, hw: Tuple[int, int]) -> float:
    """Forward conv FLOPs of one image: padding-1 convs, floor max-pools,
    the transposed convs (every input pixel meets the whole kernel), the
    decoder's 3x3 DoubleConvs at the skips' sizes, the 1x1 head."""
    dims, k, m = cfg["CNN_dimensions"], cfg["kernel_size"], cfg["maxpool_size"]

    def conv(cin, cout, kk, h, w):
        ho, wo = _conv_out(h, w, kk)
        return 2 * kk * kk * cin * cout * ho * wo, ho, wo

    f1, h, w = conv(cfg["n_channels"], dims[0], k, *hw)
    f2, h, w = conv(dims[0], dims[0], k, h, w)
    total, sizes = f1 + f2, [(h, w)]
    for i in range(1, len(dims)):
        f1, h, w = conv(dims[i - 1], dims[i], k, h // m, w // m)
        f2, h, w = conv(dims[i], dims[i], k, h, w)
        total += f1 + f2
        sizes.append((h, w))
    ku = k - 1
    for j in range(len(dims) - 1):
        cin, cout = dims[-1 - j], dims[-2 - j]
        total += 2 * ku * ku * cin * (cin // 2) * h * w
        f1, h, w = conv(cin, cout, 3, *sizes[-2 - j])
        f2, h, w = conv(cout, cout, 3, h, w)
        total += f1 + f2
    return float(total + 2 * dims[0] * cfg["n_classes"] * h * w)


class Site(NamedTuple):
    name: str
    n: int
    h: int
    w: int
    cin: int  # both sources at up_j/conv1
    cout: int
    k: int
    in_elems: int  # int8 input elements read
    out_bytes_per_elem: int  # over its consumers


def int8_sites(cfg: dict, n: int, hw: Tuple[int, int]) -> List[Site]:
    """The quantized convs of an (n, n_channels, *hw) forward, in graph
    order: inc/conv2, down_i/conv{1,2}, up_j/conv{1,2}."""
    dims, k, m, s = cfg["CNN_dimensions"], cfg["kernel_size"], cfg["maxpool_size"], cfg["upconv_stride"]
    L = len(dims)
    out: List[Site] = []
    h, w = _conv_out(*hw, k)  # inc/conv1's output
    sizes = []
    for level in range(L):
        if level:
            h, w = h // m, w // m
            cin = dims[level - 1]
            out.append(Site(f"down_{level - 1}/conv1", n, h, w, cin, dims[level], k, n * h * w * cin, 1))
            h, w = _conv_out(h, w, k)
        name = "inc/conv2" if level == 0 else f"down_{level - 1}/conv2"
        # above the bottom: the skip and the max-pool's input, both int8;
        # the bottom's feeds the float upconv
        out.append(Site(name, n, h, w, dims[level], dims[level], k, n * h * w * dims[level], 2))
        h, w = _conv_out(h, w, k)
        sizes.append((h, w))
    h, w = sizes[-1]
    for j in range(L - 1):
        cin, cout = dims[L - 1 - j], dims[L - 2 - j]
        hu, wu = (h - 1) * s + k - 1, (w - 1) * s + k - 1  # the upconv's output, unpadded
        hs, ws = sizes[L - 2 - j]
        half = cin // 2
        out.append(Site(f"up_{j}/conv1", n, hs, ws, cin, cout, 3, n * hs * ws * half + n * hu * wu * half, 1))
        h, w = _conv_out(hs, ws, 3)
        # the next upconv and the head are float: 2 bytes (bfloat16)
        out.append(Site(f"up_{j}/conv2", n, h, w, cout, cout, 3, n * h * w * cout, 2))
        h, w = _conv_out(h, w, 3)
    return out


def site_bound_ms(site: Site, peaks: Peaks) -> Tuple[float, float]:
    """(ms for the bytes, ms for the operations) of one site: its int8
    input and weights read once, its outputs written once, and three
    float32 epilogue vectors (scale, BN multiplier and shift)."""
    ho, wo = _conv_out(site.h, site.w, site.k)
    m, kk = site.n * ho * wo, site.k * site.k * site.cin
    nbytes = site.in_elems + site.cout * kk + m * site.cout * site.out_bytes_per_elem + 3 * 4 * site.cout
    return 1e3 * nbytes / peaks.bytes_per_s, 1e3 * 2 * m * kk * site.cout / peaks.int8_ops


def conv_int8_bound_ms(cfg: dict, n: int, hw: Tuple[int, int], peaks: Peaks) -> float:
    """The summed least time of every quantized site of one forward of n
    finger images."""
    return sum(max(site_bound_ms(s, peaks)) for s in int8_sites(cfg, n, hw))


def preprocess_bytes(n: int, frame: Tuple[int, int], net_in: Tuple[int, int]) -> int:
    """The front end's bytes: (n, 6, *frame) float32 frames and a (6,
    *frame) base read once, the (2n, 3, *net_in) float32 input written
    once."""
    return 4 * (n * 6 * frame[0] * frame[1] + 6 * frame[0] * frame[1] + 2 * n * 3 * net_in[0] * net_in[1])


def preprocess_bound_ms(n: int, frame, net_in, peaks: Peaks) -> float:
    return 1e3 * preprocess_bytes(n, frame, net_in) / peaks.bytes_per_s


def call_flops(cfg: dict, dual_frames: int) -> float:
    """Model FLOPs of a serving call: two finger images a dual frame."""
    return 2.0 * dual_frames * unet_conv_flops(cfg, tuple(cfg["input_tactile_image_size"]))


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of a training step of ``batch`` finger images: the
    forward's conv FLOPs and twice them for the backward (the gradients
    of the inputs and of the weights)."""
    return 3.0 * batch * unet_conv_flops(cfg, tuple(cfg["input_tactile_image_size"]))
