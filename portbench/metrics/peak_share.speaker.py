"""peak_share.speaker: WavLM's least time over the device time of the
events launched inside the program's `preprocess.speaker` spans, as a
percentage. The least time is the operations of its convolutions and
matrix products (`flops`, attention's two products included) at each
span's true 16 kHz `samples`, over the bf16 peak; the widths are the
configuration file's `wavlm` entry. None where the program recorded no
such span, or the card is not in the table of peaks"""
from portbench import span_kernels


def flops(samples, sizes):
    """Operations of one clip of `samples` 16 kHz samples through WavLM
    and its x-vector head: multiply-adds count two; the feature
    convolutions, the projection, the positional convolution, each
    layer's four projections, gates, feed-forward and attention's
    Q K^T and P V over the T x T frames, the head's projector, TDNN and
    dense layer"""
    total, length, channels = 0., samples, 1
    for dim, kernel, stride in zip(sizes['conv_dim'], sizes['conv_kernel'],
                                   sizes['conv_stride']):
        length = (length - kernel) // stride + 1
        total += 2. * length * channels * dim * kernel
        channels = dim
    frames, hidden = length, sizes['hidden_size']
    heads = sizes['num_heads']
    total += 2. * frames * channels * hidden
    total += 2. * frames * hidden * (hidden // sizes['pos_groups']) * \
        sizes['pos_kernel']
    layer = (2. * frames * hidden * 4 * hidden +
             2. * frames * hidden * 8 +
             2. * 2 * frames * hidden * sizes['intermediate_size'] +
             2. * 2 * frames * frames * hidden)
    total += sizes['num_layers'] * layer
    previous = sizes['tdnn_dim'][0]
    total += 2. * frames * hidden * previous
    for dim, kernel, dilation in zip(sizes['tdnn_dim'], sizes['tdnn_kernel'],
                                     sizes['tdnn_dilation']):
        frames -= dilation * (kernel - 1)
        total += 2. * frames * previous * kernel * dim
        previous = dim
    return total + 2. * 2 * previous * sizes['xvector_dim']


def read(reading):
    chosen = span_kernels.spans(reading, 'preprocess.speaker')
    if chosen is None or reading.peak is None:
        return None
    device = sum(end - start for start, end, _ in
                 span_kernels.events(reading, chosen)) / 1e9
    if not device:
        return None
    sizes = reading.config_file['wavlm']
    least = sum(flops(span.counts['samples'], sizes) for span in chosen) / \
        reading.peak['bfloat16']
    return 100. * least / device
