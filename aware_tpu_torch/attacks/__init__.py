"""The differentiable edits of the embed solver's EOT views: the phase
vocoder's time stretch and pitch shift, the MDCT codec approximation and
the CELP channel model.  The real-codec attacks of the JAX package
(``mp3_real``, ``av_codecs``, ``voice_codecs``) run host libraries and are
not ported."""
