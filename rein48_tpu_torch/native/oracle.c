/* Copyright 2026 The rein48-tpu Authors.
 * SPDX-License-Identifier: Apache-2.0
 *
 * Native reference-parity oracle: the 2048 game with the EXACT semantics
 * and RNG call order of the Python reference (clean-room restatement of
 * the reference's game/GameClient.py — see engine/oracle.py for the
 * authoritative Python twin this file mirrors), driven by a
 * bit-compatible reimplementation of CPython's random.Random:
 *
 *   - MT19937 core (init_by_array seeding + tempered 32-bit output),
 *     the standard Matsumoto-Nishimura recurrence;
 *   - random():   53-bit double from two tempered words, exactly
 *                 ((a>>5)*2^26 + (b>>6)) / 2^53;
 *   - getrandbits(k<=32): top k bits of one word;
 *   - randint(a,b): a + _randbelow(b-a+1), where _randbelow draws
 *                 bit_length(n) bits and rejects >= n (CPython's
 *                 Random._randbelow_with_getrandbits);
 *   - uniform(a,b): a + (b-a)*random();
 *   - seeding: integer seed split into little-endian 32-bit words fed
 *                 to init_by_array (CPython random_seed for int seeds).
 *
 * Purpose: the Python oracle steps ~10k games-steps/s; parity sweeps over
 * many seeds and long games want orders of magnitude more. This module is
 * host-side test/verification infrastructure — the training hot path is
 * the XLA/Pallas engine, which is exactly why the native component lives
 * OUTSIDE it.
 *
 * Build: cc -O2 -shared -fPIC (see native/__init__.py); no libc beyond
 * stdint/string. ctypes-facing API at the bottom.
 */

#include <stdint.h>
#include <string.h>

/* ------------------------- MT19937 (CPython-compatible) -------------- */

#define MT_N 624
#define MT_M 397
#define MATRIX_A 0x9908b0dfUL
#define UPPER_MASK 0x80000000UL
#define LOWER_MASK 0x7fffffffUL

typedef struct {
    uint32_t mt[MT_N];
    int mti;
} Rng;

static void rng_init_genrand(Rng *r, uint32_t s) {
    r->mt[0] = s;
    for (r->mti = 1; r->mti < MT_N; r->mti++) {
        r->mt[r->mti] = (uint32_t)(1812433253UL *
                (r->mt[r->mti - 1] ^ (r->mt[r->mti - 1] >> 30)) +
                (uint32_t)r->mti);
    }
}

static void rng_init_by_array(Rng *r, const uint32_t *key, int key_length) {
    int i = 1, j = 0, k;
    rng_init_genrand(r, 19650218UL);
    k = (MT_N > key_length ? MT_N : key_length);
    for (; k; k--) {
        r->mt[i] = (r->mt[i] ^
                ((r->mt[i - 1] ^ (r->mt[i - 1] >> 30)) * 1664525UL)) +
                key[j] + (uint32_t)j;
        i++; j++;
        if (i >= MT_N) { r->mt[0] = r->mt[MT_N - 1]; i = 1; }
        if (j >= key_length) j = 0;
    }
    for (k = MT_N - 1; k; k--) {
        r->mt[i] = (r->mt[i] ^
                ((r->mt[i - 1] ^ (r->mt[i - 1] >> 30)) * 1566083941UL)) -
                (uint32_t)i;
        i++;
        if (i >= MT_N) { r->mt[0] = r->mt[MT_N - 1]; i = 1; }
    }
    r->mt[0] = 0x80000000UL;
}

static uint32_t rng_genrand(Rng *r) {
    uint32_t y;
    static const uint32_t mag01[2] = {0x0UL, MATRIX_A};
    if (r->mti >= MT_N) {
        int kk;
        for (kk = 0; kk < MT_N - MT_M; kk++) {
            y = (r->mt[kk] & UPPER_MASK) | (r->mt[kk + 1] & LOWER_MASK);
            r->mt[kk] = r->mt[kk + MT_M] ^ (y >> 1) ^ mag01[y & 0x1UL];
        }
        for (; kk < MT_N - 1; kk++) {
            y = (r->mt[kk] & UPPER_MASK) | (r->mt[kk + 1] & LOWER_MASK);
            r->mt[kk] = r->mt[kk + (MT_M - MT_N)] ^ (y >> 1) ^ mag01[y & 0x1UL];
        }
        y = (r->mt[MT_N - 1] & UPPER_MASK) | (r->mt[0] & LOWER_MASK);
        r->mt[MT_N - 1] = r->mt[MT_M - 1] ^ (y >> 1) ^ mag01[y & 0x1UL];
        r->mti = 0;
    }
    y = r->mt[r->mti++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680UL;
    y ^= (y << 15) & 0xefc60000UL;
    y ^= (y >> 18);
    return y;
}

/* random.Random(seed) for non-negative integer seeds: the int's
 * little-endian 32-bit words are the init_by_array key (CPython
 * random_seed); seed 0 is the single word 0. */
static void rng_seed_u64(Rng *r, uint64_t seed) {
    uint32_t key[2];
    int n = 1;
    key[0] = (uint32_t)(seed & 0xffffffffUL);
    if (seed >> 32) { key[1] = (uint32_t)(seed >> 32); n = 2; }
    rng_init_by_array(r, key, n);
}

/* random(): exactly CPython's random_random. */
static double rng_random(Rng *r) {
    uint32_t a = rng_genrand(r) >> 5, b = rng_genrand(r) >> 6;
    return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0);
}

static int bit_length_u32(uint32_t n) {
    int k = 0;
    while (n) { k++; n >>= 1; }
    return k;
}

/* getrandbits(k), k in [1, 32]. */
static uint32_t rng_getrandbits(Rng *r, int k) {
    return rng_genrand(r) >> (32 - k);
}

/* Random._randbelow_with_getrandbits(n), n >= 1. */
static uint32_t rng_randbelow(Rng *r, uint32_t n) {
    int k = bit_length_u32(n);
    uint32_t v = rng_getrandbits(r, k);
    while (v >= n) v = rng_getrandbits(r, k);
    return v;
}

/* randint(a, b) == randrange(a, b + 1). */
static int32_t rng_randint(Rng *r, int32_t a, int32_t b) {
    return a + (int32_t)rng_randbelow(r, (uint32_t)(b - a + 1));
}

static double rng_uniform(Rng *r, double a, double b) {
    return a + (b - a) * rng_random(r);
}

/* ------------------------------ Game --------------------------------- */

#define SIZE 4
#define CELLS 16

typedef struct {
    Rng rng;
    int32_t board[CELLS];     /* raw tile values, row-major */
    int32_t last_spawn_rank;  /* blank-rank of the latest spawn, -1 none */
    int32_t last_spawn_exp;   /* 1 -> tile 2, 2 -> tile 4 */
    int64_t spawn_count;
} Oracle;

/* Merge a 4-cell line toward index 0: compress nonzeros, pair-merge
 * left-to-right, single merge per tile (GameClient.py:140-180 semantics,
 * proven equivalent by the reference's own golden tables). */
static void merge_line(const int32_t *in, int32_t *out) {
    int32_t xs[SIZE];
    int n = 0, i, o = 0;
    for (i = 0; i < SIZE; i++) if (in[i]) xs[n++] = in[i];
    for (i = 0; i < n;) {
        if (i + 1 < n && xs[i] == xs[i + 1]) { out[o++] = xs[i] * 2; i += 2; }
        else out[o++] = xs[i++];
    }
    while (o < SIZE) out[o++] = 0;
}

/* Slide/merge the board; returns 1 iff the board changed. Actions:
 * 0=UP 1=DOWN 2=LEFT 3=RIGHT (the reference's int aliases). */
static int move_board(int32_t *board, int action) {
    int32_t nb[CELLS], line[SIZE], merged[SIZE];
    int r, c, changed = 0;
    for (r = 0; r < SIZE; r++) {
        switch (action) {
        case 2: /* LEFT: row r forward */
            for (c = 0; c < SIZE; c++) line[c] = board[r * SIZE + c];
            merge_line(line, merged);
            for (c = 0; c < SIZE; c++) nb[r * SIZE + c] = merged[c];
            break;
        case 3: /* RIGHT: row r reversed */
            for (c = 0; c < SIZE; c++) line[c] = board[r * SIZE + (SIZE - 1 - c)];
            merge_line(line, merged);
            for (c = 0; c < SIZE; c++) nb[r * SIZE + (SIZE - 1 - c)] = merged[c];
            break;
        case 0: /* UP: column r forward */
            for (c = 0; c < SIZE; c++) line[c] = board[c * SIZE + r];
            merge_line(line, merged);
            for (c = 0; c < SIZE; c++) nb[c * SIZE + r] = merged[c];
            break;
        default: /* DOWN: column r reversed */
            for (c = 0; c < SIZE; c++) line[c] = board[(SIZE - 1 - c) * SIZE + r];
            merge_line(line, merged);
            for (c = 0; c < SIZE; c++) nb[(SIZE - 1 - c) * SIZE + r] = merged[c];
            break;
        }
    }
    for (r = 0; r < CELLS; r++) if (nb[r] != board[r]) { changed = 1; break; }
    memcpy(board, nb, sizeof(nb));
    return changed;
}

/* Spawn with the reference's exact RNG call order: randint over the
 * row-major blank ranks, then uniform(0,1) > 0.1 -> 2 else 4
 * (GameClient.py:103-127). No-op (and NO rng draws) when full. */
static void random_fill_grid(Oracle *g) {
    int blanks[CELLS], n = 0, i, rank;
    for (i = 0; i < CELLS; i++) if (g->board[i] == 0) blanks[n++] = i;
    if (n == 0) return;
    rank = rng_randint(&g->rng, 0, n - 1);
    {
        double u = rng_uniform(&g->rng, 0.0, 1.0);
        int value = (u > 0.1) ? 2 : 4;
        g->board[blanks[rank]] = value;
        g->last_spawn_rank = rank;
        g->last_spawn_exp = (value == 2) ? 1 : 2;
        g->spawn_count++;
    }
}

/* Full board and no equal 4-neighbour pair (GameClient.py:66-100). */
static int has_game_over(const int32_t *b) {
    int r, c;
    for (r = 0; r < CELLS; r++) if (b[r] == 0) return 0;
    for (r = 0; r < SIZE; r++)
        for (c = 0; c < SIZE; c++) {
            if (r + 1 < SIZE && b[r * SIZE + c] == b[(r + 1) * SIZE + c]) return 0;
            if (c + 1 < SIZE && b[r * SIZE + c] == b[r * SIZE + c + 1]) return 0;
        }
    return 1;
}

/* ----------------------------- ctypes API ----------------------------- */

int oracle_sizeof(void) { return (int)sizeof(Oracle); }

void oracle_init(Oracle *g, uint64_t seed) {
    memset(g, 0, sizeof(*g));
    rng_seed_u64(&g->rng, seed);
    g->last_spawn_rank = -1;
}

/* Game.reset: zero board + ONE spawn (GameClient.py:33-38). */
void oracle_reset(Oracle *g) {
    memset(g->board, 0, sizeof(g->board));
    random_fill_grid(g);
}

/* Game.step: move, spawn iff changed, recompute done
 * (GameClient.py:40-51). Returns done; *changed_out optional. */
int oracle_step(Oracle *g, int action, int *changed_out) {
    int changed = move_board(g->board, action);
    if (changed) random_fill_grid(g);
    if (changed_out) *changed_out = changed;
    return has_game_over(g->board);
}

/* The reference random policy: one randint(0,3) on the same stream
 * (control/rand.py:9-11). */
int oracle_random_action(Oracle *g) {
    return rng_randint(&g->rng, 0, 3);
}

/* Play a whole game with the reference random policy; returns steps
 * taken. Board/steps readable from the struct afterwards. */
int64_t oracle_play_random(Oracle *g, int64_t max_steps) {
    int64_t steps = 0;
    oracle_reset(g);
    while (steps < max_steps) {
        int action = oracle_random_action(g);
        int done = oracle_step(g, action, 0);
        steps++;
        if (done) break;
    }
    return steps;
}

/* Accessors (no struct layout assumptions on the Python side). */
void oracle_get_board(const Oracle *g, int32_t *out16) {
    memcpy(out16, g->board, sizeof(g->board));
}
int32_t oracle_last_spawn_rank(const Oracle *g) { return g->last_spawn_rank; }
int32_t oracle_last_spawn_exp(const Oracle *g) { return g->last_spawn_exp; }
int64_t oracle_spawn_count(const Oracle *g) { return g->spawn_count; }

/* Raw RNG surface for bit-parity tests against the `random` module. */
void rng_api_seed(Rng *r, uint64_t seed) { rng_seed_u64(r, seed); }
int rng_api_sizeof(void) { return (int)sizeof(Rng); }
double rng_api_random(Rng *r) { return rng_random(r); }
double rng_api_uniform(Rng *r, double a, double b) { return rng_uniform(r, a, b); }
int32_t rng_api_randint(Rng *r, int32_t a, int32_t b) { return rng_randint(r, a, b); }
uint32_t rng_api_getrandbits(Rng *r, int k) { return rng_getrandbits(r, k); }
