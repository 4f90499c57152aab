// Native FASTA parser — the L1 sequence-I/O layer as C++ (the reference's
// FASTA handling is C++ char loops, AlignGraph.cpp:287-404; Python
// line-loop parsing is the slowest host path for multi-GB read files).
//
// Single pass over the mmap-able file bytes: sequence characters are
// concatenated into seq_buf, with per-record offsets; headers (after '>',
// to end of line) into hdr_buf with offsets.  CRLF tolerated; blank
// lines skipped.
//
// Build: g++ -O3 -shared -fPIC fastaio.cpp -o libagfasta.so

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" int64_t ag_parse_fasta(
    const char* data, int64_t n,
    char* seq_buf, int64_t* seq_off,      // seq_off[n_rec+1]
    char* hdr_buf, int64_t* hdr_off,      // hdr_off[n_rec+1]
    int64_t max_records) {
    int64_t i = 0, n_rec = 0, s_len = 0, h_len = 0;
    bool in_header = false;
    while (i < n) {
        char c = data[i];
        if (c == '>') {
            if (n_rec >= max_records) return -1;
            seq_off[n_rec] = s_len;
            hdr_off[n_rec] = h_len;
            n_rec++;
            in_header = true;
            i++;
            continue;
        }
        if (c == '\n' || c == '\r') {
            in_header = false;
            i++;
            continue;
        }
        if (in_header) {
            hdr_buf[h_len++] = c;
        } else if (n_rec > 0) {
            seq_buf[s_len++] = c;
        }
        i++;
    }
    seq_off[n_rec] = s_len;
    hdr_off[n_rec] = h_len;
    return n_rec;
}
