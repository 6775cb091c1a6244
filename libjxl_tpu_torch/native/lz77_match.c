/* LZ77 match search over entropy token streams.
 *
 * Covers the same role as the reference's hash-chain matcher
 * (lib/jxl/enc_ans.cc ApplyLZ77_LZ77 / ApplyLZ77_Optimal) with an
 * original structure: candidates are tracked in absolute-position
 * linked lists (one per trigram bucket, one per zero-run length)
 * instead of a ring-buffer window, and the greedy-lazy emission runs
 * off an explicit insertion cursor instead of update flags. The
 * trigram mixing function and the kLenCost/kDistCost tables are kept
 * identical to the reference's: both are behavior-defining tuning
 * constants of the format's LZ77 layer (changing either changes which
 * matches are found/accepted, i.e. the compressed bytes).
 *
 * Plain C interface for ctypes; built into _jxl_native.so.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

#define TRIGRAM_BUCKETS 32768
#define TRIGRAM_SHIFT 5
#define MAX_CANDIDATES 256
#define MAX_WINDOW (1u << 20)

/* Estimated bits per length token (format tuning constants). */
static const float kLenCost[17] = {
    2.797667318563126f,  3.213177690381199f,  2.5706009246743737f,
    2.408392498667534f,  2.829649191872326f,  3.3923087753324577f,
    4.029267451554331f,  4.415576699706408f,  4.509357574741465f,
    9.21481543803004f,   10.020590190114898f, 11.858671627804766f,
    12.45853300490526f,  11.713105831990857f, 12.561996324849314f,
    13.775477692278367f, 13.174027068768641f,
};

/* Estimated bits per distance token (format tuning constants). */
static const float kDistCost[139] = {
    6.368282626312716f,  5.680793277090298f,  8.347404197105247f,
    7.641619201599141f,  6.914328374119438f,  7.959808291537444f,
    8.70023120759855f,   8.71378518934703f,   9.379132523982769f,
    9.110472749092708f,  9.159029569270908f,  9.430936766731973f,
    7.278284055315169f,  7.8278514904267755f, 10.026641158289236f,
    9.976049229827066f,  9.64351607048908f,   9.563403863480442f,
    10.171474111762747f, 10.45950155077234f,  9.994813912104219f,
    10.322524683741156f, 8.465808729388186f,  8.756254166066853f,
    10.160930174662234f, 10.247329273413435f, 10.04090403724809f,
    10.129398517544082f, 9.342311691539546f,  9.07608009102374f,
    10.104799540677513f, 10.378079384990906f, 10.165828974075072f,
    10.337595322341553f, 7.940557464567944f,  10.575665823319431f,
    11.023344321751955f, 10.736144698831827f, 11.118277044595054f,
    7.468468230648442f,  10.738305230932939f, 10.906980780216568f,
    10.163468216353817f, 10.17805759656433f,  11.167283670483565f,
    11.147050200274544f, 10.517921919244333f, 10.651764778156886f,
    10.17074446448919f,  11.217636876224745f, 11.261630721139484f,
    11.403140815247259f, 10.892472096873417f, 11.1859607804481f,
    8.017346947551262f,  7.895143720278828f,  11.036577113822025f,
    11.170562110315794f, 10.326988722591086f, 10.40872184751056f,
    11.213498225466386f, 11.30580635516863f,  10.672272515665442f,
    10.768069466228063f, 11.145257364153565f, 11.64668307145549f,
    10.593156194627339f, 11.207499484844943f, 10.767517766396908f,
    10.826629811407042f, 10.737764794499988f, 10.6200448518045f,
    10.191315385198092f, 8.468384171390085f,  11.731295299170432f,
    11.824619886654398f, 10.41518844301179f,  10.16310536548649f,
    10.539423685097576f, 10.495136599328031f, 10.469112847728267f,
    11.72057686174922f,  10.910326337834674f, 11.378921834673758f,
    11.847759036098536f, 11.92071647623854f,  10.810628276345282f,
    11.008601085273893f, 11.910326337834674f, 11.949212023423133f,
    11.298614839104337f, 11.611603659010392f, 10.472930394619985f,
    11.835564720850282f, 11.523267392285337f, 12.01055816679611f,
    8.413029688994023f,  11.895784139536406f, 11.984679534970505f,
    11.220654278717394f, 11.716311684833672f, 10.61036646226114f,
    10.89849965960364f,  10.203762898863669f, 10.997560826267238f,
    11.484217379438984f, 11.792836176993665f, 12.24310468755171f,
    11.464858097919262f, 12.212747017409377f, 11.425595666074955f,
    11.572048533398757f, 12.742093965163013f, 11.381874288645637f,
    12.191870445817015f, 11.683156920035426f, 11.152442115262197f,
    11.90303691580457f,  11.653292787169159f, 11.938615382266098f,
    16.970641701570223f, 16.853602280380002f, 17.26240782594733f,
    16.644655390108507f, 17.14310889757499f,  16.910935455445955f,
    17.505678976959697f, 17.213498225466388f, 2.4162310293553024f,
    3.494587244462329f,  3.5258600986408344f, 3.4959806589517095f,
    3.098390886949687f,  3.343454654302911f,  3.588847442290287f,
    4.14614790111827f,   5.152948641990529f,  7.433696808092598f,
    9.716311684833672f,
};

/* HybridUintConfig(split_exp, 0, 0).Encode */
static inline void hybrid_encode(uint32_t value, int split_exp,
                                 uint32_t* token, uint32_t* nbits) {
  uint32_t split = 1u << split_exp;
  if (value < split) {
    *token = value;
    *nbits = 0;
    return;
  }
  int bl = 0;
  uint32_t v = value;
  while (v >> bl) bl++;
  uint32_t n = (uint32_t)(bl - 1);
  *token = split + (n - split_exp);
  *nbits = n;
}

static inline float len_cost(uint32_t len) {
  uint32_t tok, nbits;
  hybrid_encode(len, 1, &tok, &nbits);
  if (tok > 16) tok = 16;
  return kLenCost[tok] + nbits;
}

static inline float dist_cost(uint32_t dist) {
  uint32_t tok, nbits;
  hybrid_encode(dist, 7, &tok, &nbits);
  if (tok > 138) tok = 138;
  return kDistCost[tok] + nbits;
}

/* Candidate index: for every inserted position, the most recent earlier
 * position sharing its trigram bucket (link_tri) and sharing its
 * zero-run length (link_zrun). Absolute positions, -1 = none. */
typedef struct {
  const uint32_t* tok;
  uint32_t n;
  uint32_t min_length;
  const int32_t* special_lookup; /* dist -> symbol, -1 none */
  int special_max;
  int num_special;
  int32_t* bucket_head;  /* [TRIGRAM_BUCKETS] */
  int32_t* zrun_head;    /* [n + 1]: head per current zero-run length */
  int32_t* link_tri;     /* [n] */
  int32_t* link_zrun;    /* [n] */
  uint32_t* zrun_at;     /* [n]: forward zero-run length at position */
  uint32_t cur_zrun;     /* zero-run length at the last inserted pos */
  uint32_t inserted;     /* positions [0, inserted) are indexed */
} Matcher;

static inline uint32_t trigram(const Matcher* m, uint32_t pos) {
  if (pos + 2 >= m->n) return 0;
  uint32_t h = m->tok[pos] ^ (m->tok[pos + 1] << TRIGRAM_SHIFT) ^
               (m->tok[pos + 2] << (2 * TRIGRAM_SHIFT));
  return h & (TRIGRAM_BUCKETS - 1);
}

static int matcher_init(Matcher* m, const uint32_t* tok, uint32_t n,
                        uint32_t min_length, const int32_t* special_lookup,
                        int special_max, int num_special) {
  memset(m, 0, sizeof(*m));
  m->tok = tok;
  m->n = n;
  m->min_length = min_length;
  m->special_lookup = special_lookup;
  m->special_max = special_max;
  m->num_special = num_special;
  m->bucket_head = (int32_t*)malloc(TRIGRAM_BUCKETS * sizeof(int32_t));
  m->zrun_head = (int32_t*)malloc(((size_t)n + 1) * sizeof(int32_t));
  m->link_tri = (int32_t*)malloc((size_t)n * sizeof(int32_t));
  m->link_zrun = (int32_t*)malloc((size_t)n * sizeof(int32_t));
  m->zrun_at = (uint32_t*)malloc((size_t)n * sizeof(uint32_t));
  if (!m->bucket_head || !m->zrun_head || !m->link_tri || !m->link_zrun ||
      !m->zrun_at) {
    return -1;
  }
  memset(m->bucket_head, -1, TRIGRAM_BUCKETS * sizeof(int32_t));
  memset(m->zrun_head, -1, ((size_t)n + 1) * sizeof(int32_t));
  return 0;
}

static void matcher_free(Matcher* m) {
  free(m->bucket_head);
  free(m->zrun_head);
  free(m->link_tri);
  free(m->link_zrun);
  free(m->zrun_at);
}

/* Index one position (must be called in increasing position order). */
static void matcher_insert(Matcher* m, uint32_t pos) {
  uint32_t b = trigram(m, pos);
  m->link_tri[pos] = m->bucket_head[b];
  m->bucket_head[b] = (int32_t)pos;
  /* forward zero-run length: decrement of the previous run, or a fresh
   * scan when a run starts (amortized O(1) per position) */
  uint32_t z;
  if (pos > 0 && m->tok[pos] != m->tok[pos - 1]) {
    m->cur_zrun = 0;
  }
  if (m->cur_zrun > 0) {
    z = m->cur_zrun - 1;
  } else {
    z = 0;
    while (pos + z < m->n && m->tok[pos + z] == 0) z++;
  }
  m->cur_zrun = z;
  m->zrun_at[pos] = z;
  m->link_zrun[pos] = m->zrun_head[z];
  m->zrun_head[z] = (int32_t)pos;
  m->inserted = pos + 1;
}

static inline void matcher_catch_up(Matcher* m, uint32_t pos) {
  while (m->inserted <= pos) matcher_insert(m, m->inserted);
}

static inline uint32_t dist_to_symbol(const Matcher* m, uint32_t dist) {
  if ((int)dist <= m->special_max && m->special_lookup[dist] >= 0) {
    return (uint32_t)m->special_lookup[dist];
  }
  return (uint32_t)(m->num_special) + dist - 1;
}

/* Shared candidate walk. For each candidate position, computes the
 * match length (with the zero-run fast-forward) and calls EMIT(len,
 * dist). The walk starts on the trigram list and hops onto the
 * zero-run list when the current position sits in a long zero run and
 * the last match extended past it — long runs of zeros alias in the
 * trigram bucket, and the run-length list reaches across them. */
#define CANDIDATE_WALK(m, pos, EMIT)                                        \
  do {                                                                      \
    uint32_t zhere = (m)->zrun_at[pos];                                     \
    int32_t cand = (m)->link_tri[pos];                                      \
    int on_zlist = 0;                                                       \
    uint32_t last_len = 0;                                                  \
    for (int steps = 0; steps < MAX_CANDIDATES && cand >= 0; steps++) {     \
      uint32_t dist = pos - (uint32_t)cand;                                 \
      if (dist > MAX_WINDOW) break;                                         \
      uint32_t i = pos, j = (uint32_t)cand;                                 \
      if (zhere > 3) {                                                      \
        /* both sides start with runs of zeros: skip the shared prefix */   \
        uint32_t skip = zhere - 1;                                          \
        if ((m)->zrun_at[cand] < skip) skip = (m)->zrun_at[cand];           \
        if (i + skip >= (m)->n) skip = (m)->n - i - 1;                      \
        i += skip;                                                          \
        j += skip;                                                          \
      }                                                                     \
      while (i < (m)->n && (m)->tok[i] == (m)->tok[j]) {                    \
        i++;                                                                \
        j++;                                                                \
      }                                                                     \
      uint32_t len = i - pos;                                               \
      last_len = len;                                                       \
      if (len >= (m)->min_length) {                                         \
        uint32_t dsym = dist_to_symbol((m), dist);                          \
        EMIT(len, dsym);                                                    \
      }                                                                     \
      /* next candidate: zero-run list inside long runs, else trigram */    \
      if (zhere >= 3 && last_len > zhere) {                                 \
        int32_t nx = (m)->link_zrun[cand];                                  \
        if (nx >= 0 && (m)->zrun_at[nx] != zhere) nx = -1;                  \
        cand = nx;                                                          \
        on_zlist = 1;                                                       \
      } else if (on_zlist) {                                                \
        break;                                                              \
      } else {                                                              \
        cand = (m)->link_tri[cand];                                         \
      }                                                                     \
    }                                                                       \
  } while (0)

/* Best single match at pos: longest, ties broken by lower distance
 * symbol. (An earlier slack-band heuristic here was dead logic — the
 * candidate walk visits distances in increasing order, so the first
 * match of the winning length already has the lowest symbol.) */
static void best_match(const Matcher* m, uint32_t pos, uint32_t* out_dsym,
                       uint32_t* out_len) {
  uint32_t r_len = 1, r_dsym = 0;
#define EMIT_BEST(len, dsym)                                   \
  do {                                                         \
    if ((len) > r_len || ((len) == r_len && r_dsym > (dsym))) { \
      r_len = (len);                                           \
      r_dsym = (dsym);                                         \
    }                                                          \
  } while (0)
  CANDIDATE_WALK(m, pos, EMIT_BEST);
#undef EMIT_BEST
  *out_len = r_len;
  *out_dsym = r_dsym;
}

/* Greedy-lazy match emission. Outputs accepted matches; literals are
 * the gaps. Returns the number of matches, or -1 on allocation failure.
 * cum_cost: f32[n+1] cumulative literal bit costs.
 * dist_ctx_cost: estimated bits for one distance-context symbol. */
int lz77_find_matches(const uint32_t* vals, uint32_t n,
                      const float* cum_cost, float dist_ctx_cost,
                      uint32_t min_length,
                      const int32_t* special_lookup, int special_max,
                      int num_special,
                      uint32_t* m_pos, uint32_t* m_len, uint32_t* m_dist,
                      float* bit_decrease_out) {
  Matcher m;
  if (matcher_init(&m, vals, n, min_length, special_lookup, special_max,
                   num_special)) {
    matcher_free(&m);
    return -1;
  }
  const uint32_t kLazyProbeLimit = 256;
  float bit_decrease = 0;
  int n_matches = 0;
  uint32_t pos = 0;
  while (pos < n) {
    matcher_catch_up(&m, pos);
    uint32_t len, dsym;
    best_match(&m, pos, &dsym, &len);
    if (len < min_length) {
      pos++; /* literal */
      continue;
    }
    if (len < kLazyProbeLimit && pos + 1 < n) {
      /* lazy probe: a match starting one later may be longer */
      matcher_catch_up(&m, pos + 1);
      uint32_t len2, dsym2;
      best_match(&m, pos + 1, &dsym2, &len2);
      if (len2 > len) {
        pos++;
        len = len2;
        dsym = dsym2;
      }
    }
    float lit_bits = cum_cost[pos + len] - cum_cost[pos];
    float lz_bits =
        len_cost(len - min_length) + dist_cost(dsym) + dist_ctx_cost;
    if (lz_bits <= lit_bits) {
      m_pos[n_matches] = pos;
      m_len[n_matches] = len;
      m_dist[n_matches] = dsym;
      n_matches++;
      bit_decrease += lit_bits - lz_bits;
    }
    matcher_catch_up(&m, pos + len - 1);
    pos += len;
  }
  matcher_free(&m);
  *bit_decrease_out = bit_decrease;
  return n_matches;
}

/* ---- optimal matching (shortest-path DP over all match lengths) ---- */

/* HybridUintConfig(split_exp, msb, lsb).Encode */
static inline void hybrid_encode2(uint32_t value, int split_exp, int msb,
                                  int lsb, uint32_t* token, uint32_t* nbits) {
  uint32_t split = 1u << split_exp;
  if (value < split) {
    *token = value;
    *nbits = 0;
    return;
  }
  int bl = 0;
  uint32_t v = value;
  while (v >> bl) bl++;
  uint32_t nn = (uint32_t)(bl - 1);
  uint32_t mm = value - (1u << nn);
  *token = split + ((((nn - (uint32_t)split_exp) << (msb + lsb)) +
                     ((mm >> (nn - msb)) << lsb) + (mm & ((1u << lsb) - 1))));
  *nbits = nn - msb - lsb;
}

/* All matches at pos: the lowest distance symbol usable for each length
 * in dist_for_len[min_length..max_len] (a longer match also provides
 * every shorter length at its distance, hence the suffix-min pass). */
static void all_matches(const Matcher* m, uint32_t pos,
                        uint32_t* dist_for_len, uint32_t* max_len_out) {
  uint32_t cur_max = 0;
#define EMIT_ALL(len, dsym)                              \
  do {                                                   \
    if ((len) > cur_max) {                               \
      for (uint32_t k = cur_max + 1; k <= (len); k++)    \
        dist_for_len[k] = (dsym);                        \
      cur_max = (len);                                   \
    }                                                    \
    if ((dsym) < dist_for_len[len]) dist_for_len[len] = (dsym); \
  } while (0)
  CANDIDATE_WALK(m, pos, EMIT_ALL);
#undef EMIT_ALL
  if (cur_max >= m->min_length) {
    uint32_t best = dist_for_len[cur_max];
    for (uint32_t j = cur_max;; j--) {
      if (dist_for_len[j] < best) best = dist_for_len[j];
      dist_for_len[j] = best;
      if (j <= m->min_length) break;
    }
  }
  *max_len_out = cur_max;
}

#define LEN_TOK_TABLE 32

int lz77_optimal(const uint32_t* vals, const int32_t* ctxs, uint32_t n,
                 const float* lit_cum, const float* len_tok_cost, int num_ctx,
                 int len_split_exp, int len_msb, int len_lsb,
                 const float* dist_tok_cost, int ndist_tok, int dist_split_exp,
                 int dist_msb, int dist_lsb, uint32_t min_length,
                 const int32_t* special_lookup, int special_max,
                 int num_special, uint32_t* m_pos, uint32_t* m_len,
                 uint32_t* m_dist, float* bits_out) {
  Matcher m;
  float* cost = (float*)malloc(((size_t)n + 1) * sizeof(float));
  uint32_t* plen = (uint32_t*)malloc(((size_t)n + 1) * sizeof(uint32_t));
  uint32_t* pdist = (uint32_t*)malloc(((size_t)n + 1) * sizeof(uint32_t));
  uint32_t* dfl = (uint32_t*)malloc(((size_t)n + 2) * sizeof(uint32_t));
  if (matcher_init(&m, vals, n, min_length, special_lookup, special_max,
                   num_special) ||
      !cost || !plen || !pdist || !dfl) {
    matcher_free(&m);
    free(cost);
    free(plen);
    free(pdist);
    free(dfl);
    return -1;
  }
  for (uint32_t i = 0; i <= n; i++) {
    cost[i] = 3.4e38f;
    plen[i] = 1;
    pdist[i] = 0;
  }
  cost[0] = 0.0f;
  uint32_t rle_run = 0, skip_matching = 0;
  for (uint32_t i = 0; i < n; i++) {
    matcher_catch_up(&m, i);
    /* literal edge */
    float lit = cost[i] + (lit_cum[i + 1] - lit_cum[i]);
    if (cost[i + 1] > lit) {
      cost[i + 1] = lit;
      plen[i + 1] = 1;
      pdist[i + 1] = 0;
    }
    if (skip_matching > 0) {
      skip_matching--;
      continue;
    }
    uint32_t max_len = 0;
    all_matches(&m, i, dfl, &max_len);
    if (max_len < min_length) continue;
    int ci = ctxs[i];
    if (ci < 0 || ci >= num_ctx) ci = 0;
    const float* lct = len_tok_cost + (size_t)ci * LEN_TOK_TABLE;
    /* Relax every length up to 64; beyond that the length-token cost is
     * flat within a hybrid-uint class, so only class-boundary lengths
     * and the maximum are candidates worth relaxing (keeps the DP from
     * going quadratic on highly repetitive streams). */
    uint32_t dense_end = max_len < 64 ? max_len : 64;
    for (uint32_t j = min_length; j <= max_len;) {
      uint32_t ltok, lnb, dtok, dnb;
      hybrid_encode2(j - min_length, len_split_exp, len_msb, len_lsb, &ltok,
                     &lnb);
      if (ltok >= LEN_TOK_TABLE) ltok = LEN_TOK_TABLE - 1;
      hybrid_encode2(dfl[j], dist_split_exp, dist_msb, dist_lsb, &dtok, &dnb);
      if ((int)dtok >= ndist_tok) dtok = (uint32_t)(ndist_tok - 1);
      float lz_cost = lct[ltok] + lnb + dist_tok_cost[dtok] + dnb;
      float total = cost[i] + lz_cost;
      if (cost[i + j] > total) {
        cost[i + j] = total;
        plen[i + j] = j;
        pdist[i + j] = dfl[j] + 1;
      }
      if (j <= dense_end) {
        j++;
      } else if (j >= max_len) {
        break;
      } else {
        j += (j >> 3) + 1; /* ~12% steps through the flat-cost region */
        if (j > max_len) j = max_len;
      }
    }
    /* avoid quadratic behavior inside long runs of one symbol */
    int is_rle = (num_special == 0 && dfl[max_len] == 0) ||
                 (num_special != 0 && dfl[max_len] == 1);
    rle_run = is_rle ? rle_run + 1 : 0;
    if (rle_run >= 8 && max_len > 8) {
      skip_matching = max_len - 9;
      rle_run = 0;
    }
  }
  /* backtrack (matches in reverse, then reverse in place) */
  int nm = 0;
  uint32_t pos = n;
  while (pos > 0) {
    if (pdist[pos] != 0) {
      uint32_t L = plen[pos];
      m_pos[nm] = pos - L;
      m_len[nm] = L;
      m_dist[nm] = pdist[pos] - 1;
      nm++;
      pos -= L;
    } else {
      pos -= plen[pos];
    }
  }
  for (int a = 0, b = nm - 1; a < b; a++, b--) {
    uint32_t t;
    t = m_pos[a]; m_pos[a] = m_pos[b]; m_pos[b] = t;
    t = m_len[a]; m_len[a] = m_len[b]; m_len[b] = t;
    t = m_dist[a]; m_dist[a] = m_dist[b]; m_dist[b] = t;
  }
  *bits_out = cost[n];
  matcher_free(&m);
  free(cost);
  free(plen);
  free(pdist);
  free(dfl);
  return nm;
}
