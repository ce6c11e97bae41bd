from . import fargan, grid, mel, resblock, sparse, spectral, stft, viterbi
